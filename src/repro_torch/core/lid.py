"""Local Intrinsic Dimensionality estimation (port of :mod:`repro.core.lid`).

The MLE / Hill estimator of Eq. 5 over the k nearest-neighbour distances
r_1 <= ... <= r_k:  LID(x) = -((1/k) sum_i ln(r_i / r_k))^-1, plus the
population calibration (mu, sigma) of the mapping function.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import distance as dist_mod
from repro_torch.kernels import ops

# Zero/duplicate distances would send ln(r_i/r_k) to -inf.
_EPS = 1e-12
# Estimates beyond this are estimator noise; the clamp keeps z-scores stable.
_LID_MAX = 4096.0


def lid_from_sorted_dists(r: torch.Tensor) -> torch.Tensor:
    """Eq. 5 on ascending *true* distances ``r`` of shape (..., k)."""
    r = r.clamp_min(_EPS)
    mean = torch.log(r / r[..., -1:]).mean(-1)
    # mean == 0 when all k distances are equal: treat as maximally complex.
    return -1.0 / mean.clamp_max(-1.0 / _LID_MAX)


def lid_from_dists(dists: torch.Tensor, *, squared: bool = True) -> torch.Tensor:
    """(B, k) neighbour distances in any order (squared L2 by default) ->
    (B,) LID estimates."""
    d = torch.sort(dists, dim=-1).values
    if squared:
        d = torch.sqrt(d.clamp_min(0.0))
    return lid_from_sorted_dists(d)


@dataclasses.dataclass(frozen=True)
class LidProfile:
    """The frozen geometric profile of Phase 1: per-point LID and the
    population mean and (population) standard deviation."""

    lid: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor

    def zscore(self, lid: torch.Tensor) -> torch.Tensor:
        """Eq. 7's z-score, sigma clamped at 1e-6."""
        return (lid - self.mu) / self.sigma.clamp_min(1e-6)


def calibrate(lid: torch.Tensor) -> LidProfile:
    """Population statistics over per-point LID estimates.  sigma is the
    population std (ddof 0), as ``jnp.std`` computes it."""
    return LidProfile(lid=lid, mu=lid.mean(), sigma=lid.std(correction=0))


def estimate_dataset_lid(x: torch.Tensor, k: int = 16, chunk_q: int = 4096,
                         chunk: int = 65536,
                         metric: str = dist_mod.L2) -> LidProfile:
    """Phase 1 (Geometric Calibration) of Algorithm 1: exact k-NN of every
    point, batched MLE, population aggregation.  For L2 the estimate runs
    through the ``lid_estimate`` kernel on :func:`knn_graph`'s ascending
    output, with that kernel's clamp (1e-24 on d2; the reference's
    :func:`lid_from_dists` clamps r at 1e-12, which differs only for
    d2 < 1e-24).  Other metrics take :func:`lid_from_dists` on the raw
    distances (``squared=False``), as the reference does, whatever numbers
    that gives for negated inner products."""
    d, _ = dist_mod.knn_graph(x, k=k, metric=metric, chunk_q=chunk_q,
                              chunk=chunk)
    if metric == dist_mod.L2:
        return calibrate(ops.lid_estimate(d))
    return calibrate(lid_from_dists(d, squared=False))


def bootstrap_stats(x: torch.Tensor, generator: torch.Generator | None = None,
                    sample: int = 2048, k: int = 16, metric: str = dist_mod.L2,
                    *, sample_idx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Online-MCGI Phase 1 (Algorithm 2): (mu, sigma) from a sample.

    ``sample`` points, drawn without replacement from ``generator`` (one
    ``randperm``; torch's default generator when None), are queried
    against the *full* dataset with :func:`brute_force_topk` (the
    ``l2_distance`` and ``topk`` kernels on the card), so the radii are
    unbiased; the self match is dropped by id.  ``sample_idx`` takes a
    given draw instead (torch cannot reproduce ``jax.random.choice``).
    Returns the mean and population std of the sample's LID estimates."""
    n, dev = x.shape[0], x.device
    if sample_idx is None:
        sample_idx = torch.randperm(n, generator=generator,
                                    device=dev)[:min(sample, n)]
    idx = torch.as_tensor(sample_idx, device=dev).long()
    d, ids = dist_mod.brute_force_topk(x[idx], x, k + 1, metric=metric)
    d = torch.where(ids == idx[:, None], torch.inf, d)
    d = torch.sort(d, dim=1).values[:, :k]
    lid = lid_from_dists(d, squared=(metric == dist_mod.L2))
    return lid.mean(), lid.std(correction=0)


def online_lid(cand_dists: torch.Tensor, k: int) -> torch.Tensor:
    """LID from a search candidate pool: (B, C) squared distances, invalid
    entries +inf -> (B,) estimates from the k closest valid candidates.

    An inf tail is replaced by the largest finite value (conservative:
    higher LID, stricter alpha)."""
    d = torch.sort(cand_dists, dim=-1).values[:, :k]
    finite = torch.isfinite(d)
    max_finite = torch.where(finite, d, -torch.inf).amax(-1, keepdim=True)
    d = torch.where(finite, d, max_finite)
    return lid_from_dists(d, squared=True)
