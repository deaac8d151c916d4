"""Distance primitives (port of :mod:`repro.core.distance`).

Graph algorithms work on *squared* L2 distances; the LID estimator takes the
square root itself.  The exact scans (:func:`brute_force_topk`,
:func:`knn_graph`) run through the ``l2_distance`` and ``topk`` kernels
(:mod:`repro_torch.kernels.ops`).  :func:`squared_l2` stays the library
expression (``torch.matmul`` in full float32: the package disables TF32)
for the callers that want a plain distance matrix.

The inner-product metrics (``ip``, and ``cosine`` on unit-normalised rows)
are a distance of ``-(q . x)``, smaller is more similar, as the reference
computes them outside any Pallas kernel: the product stays
``torch.matmul``, and the scans select with the ``topk`` kernel on those
(negative) values.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

# Metric names accepted across the package.
L2 = "l2"
IP = "ip"  # inner product (maximum inner product search, negated)
COSINE = "cosine"


def squared_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D), (N, D) -> (Q, N) squared distances via |q|^2 - 2 q.x + |x|^2."""
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)
    d2 = qn - 2.0 * (q @ x.T) + xn[None, :]
    return d2.clamp_min(0.0)


def neg_inner_product(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negated inner product as a distance (smaller = more similar)."""
    return -(q @ x.T)


def _unit_rows(v: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm + 1e-12 (the reference's cosine)."""
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str = L2) -> torch.Tensor:
    """(Q, D), (N, D) -> (Q, N) distances in ``metric``."""
    if metric == L2:
        return squared_l2(q, x)
    if metric == IP:
        return neg_inner_product(q, x)
    if metric == COSINE:
        return neg_inner_product(_unit_rows(q), _unit_rows(x))
    raise ValueError(f"unknown metric {metric!r}")


def point_to_points(q: torch.Tensor, x: torch.Tensor,
                    metric: str = L2) -> torch.Tensor:
    """(D,) query vs (M, D) points -> (M,) distances."""
    return pairwise(q[None, :], x, metric)[0]


def brute_force_topk(q: torch.Tensor, x: torch.Tensor, k: int,
                     metric: str = L2, chunk: int = 65536
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k nearest neighbours (any k >= 1) by a chunked scan over the
    base set: for each chunk one distance matrix and one :func:`ops.topk`
    (the kernel on the card, its plain version on the CPU), merged into the
    running best with a stable sort, so ties go to the lower id wherever
    they fall; the result equals one stable argsort over all N and does not
    depend on ``chunk``.  The L2 matrix is :func:`ops.bulk_l2` (the
    ``l2_distance`` kernel); ``ip`` and ``cosine`` are
    :func:`neg_inner_product` (cosine on rows normalised once up front,
    as the reference normalises each chunk's rows).

    Returns (dists, ids): each (Q, k), ascending (ids int32; -1/inf where
    N < k).
    """
    if metric not in (L2, IP, COSINE):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == COSINE:
        q, x = _unit_rows(q), _unit_rows(x)
    n, nq = x.shape[0], q.shape[0]
    q, x = q.contiguous(), x.contiguous()
    best_d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, n, chunk):
        xs = x[start:start + chunk]
        d = (ops.bulk_l2(q, xs) if metric == L2
             else neg_inner_product(q, xs).contiguous())
        d, pos = ops.topk(d, min(k, d.shape[1]))
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, pos + start], 1)
        order = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
        best_d = torch.gather(cat_d, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_d, best_i


def knn_graph(x: torch.Tensor, k: int, metric: str = L2, chunk_q: int = 1024,
              chunk: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of every point against the dataset, self excluded: one
    :func:`brute_force_topk` of k + 1 per ``chunk_q`` rows.

    Returns (dists, ids): each (N, k), ascending; squared L2 for the l2
    metric.
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
    """Mean Recall@k between predicted and ground-truth id sets (both (Q, k)).

    The mean is the hit count times the float32 reciprocal of the count, as
    XLA takes ``jnp.mean``: a correctly rounded division can land one ulp
    lower, which flips a calibration fit whose recall equals its target.
    """
    hits = (pred_ids[:, :, None] == true_ids[:, None, :]).any(1)
    inv = torch.tensor(1.0 / max(hits.numel(), 1), dtype=torch.float32,
                       device=hits.device)
    return hits.sum(dtype=torch.float32) * inv
