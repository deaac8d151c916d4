"""Exact nearest neighbours and squared L2 distances, plain PyTorch.

``dtype`` is float64 for the reference; the control runs the same code in
bfloat16 (``exact_topk(..., dtype=torch.bfloat16)``) in the program's place.
"""
from __future__ import annotations

import torch

# Largest (queries, rows) block of distances held at once, in elements.
BLOCK_ELEMENTS = 1 << 28


def exact_topk(x: torch.Tensor, queries: torch.Tensor, k: int,
               dtype=torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids (Q, k) int64, d2 (Q, k)) of the k nearest rows of ``x`` to each
    query, ascending, by |q|^2 - 2 q.x + |x|^2 in ``dtype``; in blocks of
    queries so that a block's distances stay under ``BLOCK_ELEMENTS``."""
    xd = x.to(dtype)
    xn = (xd * xd).sum(1)
    step = max(1, BLOCK_ELEMENTS // max(1, x.shape[0]))
    ids, d2 = [], []
    for s in range(0, queries.shape[0], step):
        q = queries[s:s + step].to(dtype)
        d = (q * q).sum(1, keepdim=True) - 2.0 * (q @ xd.T) + xn[None, :]
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids.append(i)
        d2.append(v)
    return torch.cat(ids), torch.cat(d2)


def pair_d2(x: torch.Tensor, queries: torch.Tensor, qidx: torch.Tensor,
            ids: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Squared L2 distance of query ``qidx[i]`` to row ``ids[i, j]`` in
    ``dtype``, summed over the differences: (Q, k).  Invalid ids (< 0 or
    >= N) read as nan."""
    n = x.shape[0]
    ok = (ids >= 0) & (ids < n)
    rows = x[ids.clamp(0, n - 1).long()].to(dtype)
    diff = rows - queries[qidx.long()].to(dtype)[:, None, :]
    d2 = (diff * diff).sum(-1)
    return torch.where(ok, d2, torch.full_like(d2, float("nan")))


def recall_hits(ids: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(Q,) count of each row of ``gt`` (Q, k) found in the same row of
    ``ids`` (Q, k)."""
    return (gt[:, :, None] == ids[:, None, :]).any(-1).sum(1)
