"""Distance primitives (port of :mod:`repro.core.distance`, L2 only).

Graph algorithms work on *squared* L2 distances; the LID estimator takes the
square root itself.  Matrix products go to ``torch.matmul`` (full float32:
the package disables TF32), as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

L2 = "l2"


def squared_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D), (N, D) -> (Q, N) squared distances via |q|^2 - 2 q.x + |x|^2."""
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)
    d2 = qn - 2.0 * (q @ x.T) + xn[None, :]
    return d2.clamp_min(0.0)


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str = L2) -> torch.Tensor:
    if metric != L2:
        raise ValueError(f"unsupported metric {metric!r} (the port has L2)")
    return squared_l2(q, x)


def _stable_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions and values of the k smallest entries per row, in the order a
    stable ascending argsort gives them (ties to the lower position).

    ``torch.topk`` picks k entries, ties at the k-th value t in no promised
    order.  Rows where more entries equal t than were picked are redone
    exactly: every entry below t, then the lowest positions equal to t.
    """
    vals, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
    t = vals[:, -1:]
    redo = ((d == t).sum(1) > (vals == t).sum(1)).nonzero()[:, 0]
    if redo.numel():
        dr, tr = d[redo], t[redo]
        less, eq = dr < tr, dr == tr
        need = k - less.sum(1, keepdim=True)
        take = less | (eq & (torch.cumsum(eq, 1) <= need))
        pos[redo] = take.nonzero()[:, 1].view(-1, k)
        vals[redo] = torch.gather(dr, 1, pos[redo])
    # Order the k picked entries by (value, position).
    by_pos = torch.argsort(pos, dim=1)
    pos, vals = torch.gather(pos, 1, by_pos), torch.gather(vals, 1, by_pos)
    order = torch.argsort(vals, dim=1, stable=True)
    return torch.gather(pos, 1, order), torch.gather(vals, 1, order)


def brute_force_topk(q: torch.Tensor, x: torch.Tensor, k: int,
                     metric: str = L2, chunk: int = 65536
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k nearest neighbours by a chunked scan over the base set.

    Each chunk's candidates merge into the running best with a stable sort,
    so ties go to the lower id wherever they fall; the result equals one
    stable argsort over all N and does not depend on ``chunk``.

    Returns (dists, ids): each (Q, k), ascending (ids int32; -1/inf where
    N < k).
    """
    n, nq = x.shape[0], q.shape[0]
    best_d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, n, chunk):
        d = pairwise(q, x[start:start + chunk], metric)
        c = d.shape[1]
        if c > 2 * k:
            pos, d = _stable_smallest(d, k)
        else:
            pos = torch.arange(c, device=q.device).expand(nq, c)
        ids = (pos + start).to(torch.int32)
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, ids], 1)
        order = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
        best_d = torch.gather(cat_d, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_d, best_i


def knn_graph(x: torch.Tensor, k: int, metric: str = L2, chunk_q: int = 1024,
              chunk: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of every point against the dataset, self excluded.

    Returns (dists, ids): each (N, k), ascending squared L2.
    """
    n = x.shape[0]
    outs_d, outs_i = [], []
    for start in range(0, n, chunk_q):
        qs = x[start:start + chunk_q]
        d, i = brute_force_topk(qs, x, k + 1, metric, chunk=chunk)
        rows = torch.arange(start, start + qs.shape[0], device=x.device)[:, None]
        d = torch.where(i == rows, torch.inf, d)       # push self to the end
        order = torch.argsort(d, dim=1, stable=True)[:, :k]
        outs_d.append(torch.gather(d, 1, order))
        outs_i.append(torch.gather(i, 1, order))
    return torch.cat(outs_d), torch.cat(outs_i)


def recall_at_k(pred_ids: torch.Tensor, true_ids: torch.Tensor) -> torch.Tensor:
    """Mean Recall@k between predicted and ground-truth id sets (both (Q, k))."""
    hits = (pred_ids[:, :, None] == true_ids[:, None, :]).any(1)
    return hits.float().mean()
