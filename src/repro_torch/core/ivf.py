"""IVF-Flat baseline (port of :mod:`repro.core.ivf`): a Faiss-style
inverted file with exact in-list distances, the paper's in-memory
throughput roofline.

A k-means coarse quantiser over ``nlist`` centroids; each base point sits
in its nearest centroid's list; a query probes the ``nprobe`` closest lists
and scans them exactly.  The lists are padded to the longest into a dense
(nlist, max_len) id matrix, as the reference lays them out, so a scan is a
fixed-shape gather.  The probe and the in-list select are the ``topk``
kernel on the card (:func:`repro_torch.kernels.ops.topk`), whose order
(ties to the lower position) is the reference's stable argsort prefix.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import distance as dist_mod
from repro_torch.kernels import ops

INVALID = -1
# Bytes of gathered in-list vectors a query chunk of search_ivf may hold.
SCAN_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class IvfIndex:
    centroids: torch.Tensor  # (nlist, D)
    lists: torch.Tensor      # (nlist, max_len) int32, INVALID padded
    list_len: torch.Tensor   # (nlist,) int32


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
        a = _assign(x, centroids, chunk)
        sums = torch.zeros_like(centroids).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)
        new = sums / counts.clamp_min(1.0)[:, None]
        centroids = torch.where((counts == 0)[:, None], centroids, new)
    return centroids


def _assign(x: torch.Tensor, centroids: torch.Tensor,
            chunk: int) -> torch.Tensor:
    """Each row's nearest centroid (the first on ties), ``chunk`` rows at a
    time: the whole (N, nlist) matrix is 15.6 GB at 1M x 3,906."""
    return torch.cat([torch.argmin(dist_mod.squared_l2(x[s:s + chunk],
                                                       centroids), dim=1)
                      for s in range(0, x.shape[0], chunk)])


def build_ivf(x, nlist: int = 256, iters: int = 10, seed: int = 0, *,
              generator: torch.Generator | None = None, init=None,
              chunk: int = 65536, device="cuda") -> IvfIndex:
    """k-means over ``nlist`` centroids, then the inverted lists on the host
    (a stable argsort of the assignment and a bincount, as the reference
    builds them).  The initial centroids are the rows ``init`` names, else
    a draw of ``generator`` (seeded with ``seed`` when None): torch cannot
    reproduce the reference's ``jax.random.choice``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if init is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    centroids = kmeans(x, nlist, iters=iters, generator=generator,
                       chunk=chunk, init=init)
    a = _assign(x, centroids, chunk).cpu().numpy()
    n = x.shape[0]
    order = np.argsort(a, kind="stable")
    sorted_ids = np.arange(n, dtype=np.int32)[order]
    counts = np.bincount(a, minlength=nlist)
    max_len = int(counts.max())
    lists = np.full((nlist, max_len), INVALID, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for c in range(nlist):
        lists[c, :counts[c]] = sorted_ids[starts[c]:starts[c] + counts[c]]
    return IvfIndex(centroids=centroids,
                    lists=torch.from_numpy(lists).to(dev),
                    list_len=torch.from_numpy(counts.astype(np.int32)).to(dev))


def search_ivf(index: IvfIndex, x: torch.Tensor, queries: torch.Tensor,
               nprobe: int = 8, k: int = 10,
               scan_bytes: int = SCAN_BYTES
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe ``nprobe`` lists a query, scan them exactly, top-k.

    The probe is :func:`squared_l2` to the centroids and one
    :func:`ops.topk` of ``nprobe``.  Each query's ``nprobe * max_len``
    padded ids are gathered, their d2 taken in the reference's difference
    form (``sum((vecs - q)^2)``, INVALID at inf) and one :func:`ops.topk`
    of k selects; queries go in chunks whose gathered vectors stay under
    ``scan_bytes``.  Where fewer than k ids are valid the tail holds
    INVALID at inf, as the reference's ``ids[order]`` does (and k columns
    shrink to ``nprobe * max_len`` where that is fewer, as there).

    Returns (ids, d2, scanned): (Q, k) int32, (Q, k) float32, (Q,) int32
    points scanned.
    """
    nlist, max_len = index.lists.shape
    nprobe = min(nprobe, nlist)
    width = nprobe * max_len
    per_query = max(1, width * x.shape[1] * x.element_size())
    step = max(1, scan_bytes // per_query)
    _, probes = ops.topk(dist_mod.squared_l2(queries, index.centroids)
                         .contiguous(), nprobe)
    out_i, out_d, out_n = [], [], []
    for s in range(0, queries.shape[0], step):
        q = queries[s:s + step]
        ids = index.lists[probes[s:s + step].long()].reshape(q.shape[0], width)
        valid = ids != INVALID
        diff = x[ids.clamp_min(0).long()] - q[:, None, :]
        d2 = torch.where(valid, (diff * diff).sum(-1), torch.inf)
        d, pos = ops.topk(d2.contiguous(), min(k, width))
        out_i.append(torch.gather(ids, 1, pos.long()))
        out_d.append(d)
        out_n.append(valid.sum(1, dtype=torch.int32))
    return torch.cat(out_i), torch.cat(out_d), torch.cat(out_n)
