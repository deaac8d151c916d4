"""The PQ fast tier built in set-up, judged against its own codebook: the
largest excess of a code's centroid distance over the nearest centroid's,
relative to the subspace's mean squared norm, every row and subspace, in
float64 (:func:`bench.reference.pq.code_excess`).  A codebook whose shape
is not the configuration's (m subspaces of K centroids) reads inf."""
import torch

from bench.reference import pq


def reading(ctx) -> float:
    cent = torch.as_tensor(ctx.outputs["centroids"], device=ctx.x.device)
    if cent.shape[0] != ctx.config["pq"]["m"] or \
            cent.shape[1] != ctx.config["pq"]["k"]:
        return float("inf")
    codes = torch.as_tensor(ctx.outputs["codes"], device=ctx.x.device)
    return pq.code_excess(ctx.x, cent, codes)
