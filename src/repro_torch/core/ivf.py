"""k-means (port of :func:`repro.core.ivf.kmeans`, the part of the IVF
module the PQ trainer needs)."""
from __future__ import annotations

import torch

from repro_torch.core import distance as dist_mod


def kmeans(x: torch.Tensor, k: int, iters: int = 10,
           generator: torch.Generator | None = None, chunk: int = 65536,
           init: torch.Tensor | None = None) -> torch.Tensor:
    """Batched Lloyd's algorithm.  The k initial centroids are distinct rows
    drawn with ``generator`` (or the rows ``init`` names); an empty cluster
    keeps its previous centroid."""
    n, dev = x.shape[0], x.device
    if init is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init = torch.randperm(n, generator=generator, device=dev)[:k]
    centroids = x[torch.as_tensor(init, device=dev).long()]
    for _ in range(iters):
        a = torch.cat([torch.argmin(dist_mod.squared_l2(x[s:s + chunk],
                                                        centroids), dim=1)
                       for s in range(0, n, chunk)])
        sums = torch.zeros_like(centroids).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)
        new = sums / counts.clamp_min(1.0)[:, None]
        centroids = torch.where((counts == 0)[:, None], centroids, new)
    return centroids
