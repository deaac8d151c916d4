"""Product Quantisation codebook training (port of
:mod:`repro.pq.codebook`).

D dims split into M contiguous subspaces of D/M dims; each gets a K-centroid
k-means codebook (K <= 256, so codes fit uint8): M bytes per vector in the
fast tier.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ivf import kmeans


@dataclasses.dataclass(frozen=True)
class PqCodebook:
    """centroids: (M, K, dsub) float32; D = M * dsub."""

    centroids: torch.Tensor

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def k(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (M, N, dsub); D must be divisible by M."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def train_pq(x: torch.Tensor, m: int = 16, k: int = 256, iters: int = 8,
             seed: int = 0, sample: int | None = 65536) -> PqCodebook:
    """Train per-subspace codebooks on (a seeded sample of) the dataset."""
    n, dev = x.shape[0], x.device
    if sample is not None and n > sample:
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = x[torch.randperm(n, generator=gen, device=dev)[:sample]]
    subs = split_subspaces(x, m).contiguous()
    books = [kmeans(subs[j], k=k, iters=iters,
                    generator=torch.Generator(device=dev).manual_seed(
                        seed + 31 * j))
             for j in range(m)]
    return PqCodebook(centroids=torch.stack(books))
