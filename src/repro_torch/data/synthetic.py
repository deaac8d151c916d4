"""Synthetic datasets with controllable manifold geometry (port of
:mod:`repro.data.synthetic`).

Draws come from a ``torch.Generator``: the distributions are the
reference's, the bits are not.  Every generator returns float32 (N, D) on
the generator's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import resolve_device


def _normal(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device)


def _uniform(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device)


def _random_rotation(g: torch.Generator, d: int) -> torch.Tensor:
    q, r = torch.linalg.qr(_normal(g, d, d))
    return q * torch.sign(torch.diagonal(r))[None, :]


def uniform_hypercube(g: torch.Generator, n: int, d: int) -> torch.Tensor:
    """Uniform ambient-dimensional data: LID ~= D everywhere."""
    return _uniform(g, n, d)


def gaussian_subspace_clusters(g: torch.Generator, n: int, d_ambient: int,
                               d_intrinsic: int, n_clusters: int = 16,
                               noise: float = 0.01) -> torch.Tensor:
    """Points on ``n_clusters`` random ``d_intrinsic``-dim affine subspaces in
    ``d_ambient`` dims + isotropic noise.  True LID ~= d_intrinsic."""
    per = n // n_clusters + 1
    basis = _normal(g, n_clusters, d_ambient, d_intrinsic)
    basis = basis / torch.linalg.norm(basis, dim=1, keepdim=True)
    centers = _normal(g, n_clusters, d_ambient) * 4.0
    coeff = _normal(g, n_clusters, per, d_intrinsic)
    pts = torch.einsum("cdi,cpi->cpd", basis, coeff) + centers[:, None, :]
    pts = pts.reshape(-1, d_ambient)[:n]
    return pts + noise * _normal(g, *pts.shape)


def swiss_roll_hd(g: torch.Generator, n: int, d_ambient: int,
                  noise: float = 0.01) -> torch.Tensor:
    """Swiss roll rotated into ``d_ambient`` dims: LID ~= 2, high curvature."""
    t = 1.5 * math.pi * (1.0 + 2.0 * _uniform(g, n))
    h = 21.0 * _uniform(g, n)
    roll = torch.stack([t * torch.cos(t), h, t * torch.sin(t)], 1) / 10.0
    x = torch.cat([roll, torch.zeros((n, d_ambient - 3), device=g.device)], 1)
    return x @ _random_rotation(g, d_ambient) + noise * _normal(g, n, d_ambient)


def mixture_of_manifolds(g: torch.Generator, n: int, d_ambient: int,
                         intrinsic_dims: tuple[int, ...] = (2, 8, 24),
                         noise: float = 0.01) -> torch.Tensor:
    """Heterogeneous-LID mixture — the geometry MCGI is designed for."""
    per = n // len(intrinsic_dims)
    parts = []
    for i, di in enumerate(intrinsic_dims):
        m = per if i < len(intrinsic_dims) - 1 else n - per * (len(intrinsic_dims) - 1)
        parts.append(gaussian_subspace_clusters(
            g, m, d_ambient, di, n_clusters=max(2, 8 // (i + 1)), noise=noise))
    return torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """A named benchmark dataset: proxy for one of the paper's five."""

    name: str
    n: int
    d: int
    n_queries: int
    generator: Callable[[torch.Generator, int, int], torch.Tensor]
    description: str = ""


def _gist_like(g, n, d):
    return mixture_of_manifolds(g, n, d, intrinsic_dims=(4, 12, 32))


def _sift_like(g, n, d):
    return gaussian_subspace_clusters(g, n, d, d_intrinsic=14, n_clusters=32)


def _glove_like(g, n, d):
    x = gaussian_subspace_clusters(g, n, d, d_intrinsic=18, n_clusters=64)
    return x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-9)


def _t2i_like(g, n, d):
    return mixture_of_manifolds(g, n, d, intrinsic_dims=(6, 18, 40))


REGISTRY: dict[str, DatasetSpec] = {
    # SIFT1M's shape (ANN_SIFT1M, INRIA TEXMEX): 1M base, 10k queries, D=128.
    "sift1m": DatasetSpec("sift1m", 1_000_000, 128, 10_000, _sift_like,
                          "SIFT1M shape: D=128, moderate homogeneous LID"),
    "sift1m-proxy": DatasetSpec("sift1m-proxy", 100_000, 128, 1000,
                                _sift_like, "SIFT1M proxy: D=128"),
    "glove-proxy": DatasetSpec("glove-proxy", 100_000, 100, 1000, _glove_like,
                               "GloVe-100 proxy: unit-norm, D=100"),
    "gist1m-proxy": DatasetSpec("gist1m-proxy", 50_000, 960, 500, _gist_like,
                                "GIST1M proxy: D=960, heterogeneous high LID"),
    "sift1b-proxy": DatasetSpec("sift1b-proxy", 200_000, 128, 1000,
                                _sift_like, "SIFT1B reduced-N proxy"),
    "t2i-proxy": DatasetSpec("t2i-proxy", 200_000, 200, 1000, _t2i_like,
                             "T2I-1B reduced-N proxy"),
    "tiny-mixture": DatasetSpec("tiny-mixture", 4000, 64, 100, _gist_like,
                                "test-scale heterogeneous mixture"),
    "tiny-uniform": DatasetSpec("tiny-uniform", 2000, 32, 100,
                                lambda g, n, d: uniform_hypercube(g, n, d),
                                "test-scale uniform cube"),
}


def make_dataset(spec: DatasetSpec | str, seed: int = 0, *, device="cuda",
                 n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (base, queries), split from one draw so queries lie on the
    base set's manifolds.  ``n`` cuts the base set (queries keep their
    count)."""
    if isinstance(spec, str):
        spec = REGISTRY[spec]
    dev = resolve_device(device)
    n = spec.n if n is None else n
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = spec.generator(g, n + spec.n_queries, spec.d).float()
    pool = pool[torch.randperm(pool.shape[0], generator=g, device=dev)]
    return pool[:n].contiguous(), pool[n:].contiguous()
