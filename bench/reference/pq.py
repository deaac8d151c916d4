"""PQ codes judged against their codebook, plain PyTorch.

A code is right when its centroid is the nearest of its subspace's
centroids to the vector's sub-vector.  :func:`code_excess` works out every
sub-vector's squared distance to every centroid again, by the differences,
and reads how far the program's chosen centroid lies beyond the nearest,
relative to the subspace's mean squared sub-vector norm (the scale of the
rounding error an expanded |s|^2 - 2 s.c + |c|^2 makes).
"""
from __future__ import annotations

import torch

ROWS_PER_BLOCK = 4096


def padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` zero-padded on the right to ``width`` columns (L2 unchanged)."""
    if x.shape[1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


def encode(x: torch.Tensor, centroids: torch.Tensor,
           dtype=torch.float64) -> torch.Tensor:
    """(N, M) int64 nearest-centroid codes of ``x`` (zero-padded to M *
    dsub) under ``centroids`` (M, K, dsub), by differences in ``dtype``."""
    m, _, dsub = centroids.shape
    cb = centroids.to(dtype)
    out = []
    for s in range(0, x.shape[0], ROWS_PER_BLOCK):
        sub = padded(x[s:s + ROWS_PER_BLOCK], m * dsub).to(dtype)
        sub = sub.reshape(-1, m, 1, dsub)
        d = ((sub - cb[None]) ** 2).sum(-1)                  # (c, M, K)
        out.append(d.argmin(-1))
    return torch.cat(out)


def code_excess(x: torch.Tensor, centroids: torch.Tensor,
                codes: torch.Tensor) -> float:
    """Largest (d(s, c_code) - min_c d(s, c)) / mean_rows |s|^2 over every
    row and subspace, in float64; inf for codes outside [0, K) or a shape
    that does not fit."""
    m, kk, dsub = centroids.shape
    if codes.shape != (x.shape[0], m) or x.shape[1] > m * dsub:
        return float("inf")
    codes = codes.long()
    if codes.numel() and (codes.min() < 0 or codes.max() >= kk):
        return float("inf")
    cb = centroids.to(torch.float64)
    norm = torch.zeros(m, dtype=torch.float64, device=x.device)
    worst = torch.zeros(m, dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], ROWS_PER_BLOCK):
        sub = padded(x[s:s + ROWS_PER_BLOCK], m * dsub).to(torch.float64)
        sub = sub.reshape(-1, m, dsub)
        d = ((sub[:, :, None, :] - cb[None]) ** 2).sum(-1)  # (c, M, K)
        got = torch.gather(d, 2, codes[s:s + ROWS_PER_BLOCK, :, None])[..., 0]
        worst = torch.maximum(worst, (got - d.min(-1).values).max(0).values)
        norm += (sub * sub).sum(-1).sum(0)
    scale = norm / max(1, x.shape[0])
    return float((worst / scale.clamp_min(1e-30)).max())
