"""Asymmetric Distance Computation (port of :mod:`repro.pq.adc`).

For a query q the per-subspace table LUT[m, c] = ||q_m - centroid[m, c]||^2
turns every approximate distance into M byte-indexed lookups:
d2(q, x_i) ~= sum_m LUT[m, code_i[m]].

:func:`adc_distances` is the plain gather (the reference's oracle);
:func:`adc_topk`, the bulk scan + top-k of the ``retrieval_cand`` serving
primitive, runs the ``pq_scan`` and ``topk`` kernels on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

BLOCK_BYTES = 1 << 30     # largest (Qc, N) float32 distance block per chunk


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


def query_chunk(n: int) -> int:
    """Queries per chunk of :func:`adc_topk`: the largest power of two whose
    (Qc, N) float32 block stays within 1 GiB (256 at N = 1M)."""
    qc = 1
    while 2 * qc * max(n, 1) * 4 <= BLOCK_BYTES:
        qc *= 2
    return qc


def adc_topk(luts: torch.Tensor, codes: torch.Tensor,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bulk ADC scan + top-k: (Q, M, K) LUTs x (N, M) codes -> ((Q, k)
    ascending distances, (Q, k) int32 ids), ties to the lower id (the
    reference's ``lax.top_k(-d, k)`` order); any 1 <= k <= N.

    Queries go in chunks of :func:`query_chunk`, each one
    ``ops.pq_bulk_scan`` and one ``ops.topk``.
    """
    n = codes.shape[0]
    qc = query_chunk(n)
    vals, ids = [], []
    for s in range(0, luts.shape[0], qc):
        v, i = ops.topk(ops.pq_bulk_scan(luts[s:s + qc], codes), k)
        vals.append(v)
        ids.append(i)
    if not vals:
        return (torch.empty((0, k), dtype=torch.float32, device=luts.device),
                torch.empty((0, k), dtype=torch.int32, device=luts.device))
    return torch.cat(vals), torch.cat(ids)
