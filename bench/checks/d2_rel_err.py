"""The largest relative error of a returned squared distance: for every
answered (query, id) with a valid id, |d2 returned - d2 of that query to
that row| / d2, the reference's d2 summed over the differences in float64.
A float32 rerank reads about 1e-7; a distance from another query, another
row, a PQ code or a lower precision reads far above.  Invalid ids and
malformed answers are ``bad_answers``' to count."""
import torch

from bench.reference import knn


def reading(ctx) -> float:
    worst = 0.0
    n = ctx.x.shape[0]
    for b in filter(ctx.well_formed, ctx.answered()):
        ids = torch.as_tensor(b.ids, device=ctx.x.device).long()
        got = torch.as_tensor(b.d2, device=ctx.x.device).double()
        idx = torch.as_tensor(b.idx, device=ctx.x.device)
        ref = knn.pair_d2(ctx.x, ctx.queries, idx, ids)
        ok = (ids >= 0) & (ids < n)
        err = (got - ref).abs() / ref.clamp_min(1e-30)
        err = torch.where(ok, err, torch.zeros_like(err))
        worst = max(worst, float(err.max()))
    return worst
