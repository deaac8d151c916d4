"""Asymmetric Distance Computation (port of :mod:`repro.pq.adc`).

For a query q the per-subspace table LUT[m, c] = ||q_m - centroid[m, c]||^2
turns every approximate distance into M byte-indexed lookups:
d2(q, x_i) ~= sum_m LUT[m, code_i[m]].
"""
from __future__ import annotations

import torch


def build_lut(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(Q, D), (M, K, dsub) -> (Q, M, K) squared-distance tables."""
    q_subs = queries.reshape(queries.shape[0], centroids.shape[0],
                             centroids.shape[2])
    diff = q_subs[:, :, None, :] - centroids[None]
    return (diff * diff).sum(-1)


def adc_distances(luts: torch.Tensor, codes: torch.Tensor,
                  chunk: int = 65536) -> torch.Tensor:
    """(Q, M, K) LUTs x (N, M) codes -> (Q, N) approximate distances."""
    m = luts.shape[1]
    sub = torch.arange(m, device=luts.device)[None, :]
    out = [luts[:, sub, codes[s:s + chunk].long()].sum(-1)
           for s in range(0, codes.shape[0], chunk)]
    if not out:
        return luts.new_zeros((luts.shape[0], 0))
    return torch.cat(out, 1)
