"""HNSW baseline (Malkov & Yashunin; port of :mod:`repro.core.hnsw`), the
in-memory graph-index ceiling.

The build is the inherently sequential insertion procedure, on the host in
numpy, the reference's code line for line (index construction is offline;
what the paper benchmarks is search), so it gives the reference's graph
bit for bit on the same rows.  Search is batched over lanes: a greedy
descent (beam 1) through the upper layers in torch, then the standard
ef-wide beam on layer 0 through the package's walk
(:func:`repro_torch.core.search.fixed_search_batch`, one ``beam_step``
exact launch on the card) from each query's own entry point.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import search as search_mod

INVALID = -1


@dataclasses.dataclass(frozen=True)
class HnswIndex:
    layers: torch.Tensor  # (n_layers, N, 2m) int32 adjacency per layer, INVALID pad
    entry: torch.Tensor   # scalar int32: the top layer's entry point
    n_layers: int = 1


def _select_heuristic(cand: list[int], dists: dict[int, float],
                      x: np.ndarray, m: int) -> list[int]:
    """HNSW Algorithm 4 neighbour-selection heuristic (keep a diverse set)."""
    out: list[int] = []
    for c in sorted(cand, key=lambda i: dists[i]):
        if len(out) >= m:
            break
        d_cq = dists[c]
        ok = True
        for s in out:
            diff = x[c] - x[s]
            if float(diff @ diff) < d_cq:
                ok = False
                break
        if ok:
            out.append(c)
    return out


def _search_layer_np(x: np.ndarray, adj: np.ndarray, q: np.ndarray,
                     entry: int, ef: int) -> dict[int, float]:
    """Host-side ef-search on one layer during construction."""

    def d(i):
        diff = x[i] - q
        return float(diff @ diff)

    visited = {entry}
    d0 = d(entry)
    cand = [(d0, entry)]       # min-heap of the frontier
    best = [(-d0, entry)]      # max-heap of the result set
    while cand:
        dc, c = heapq.heappop(cand)
        if dc > -best[0][0] and len(best) >= ef:
            break
        for nb in adj[c]:
            if nb < 0 or nb in visited:
                continue
            visited.add(int(nb))
            dn = d(int(nb))
            if len(best) < ef or dn < -best[0][0]:
                heapq.heappush(cand, (dn, int(nb)))
                heapq.heappush(best, (-dn, int(nb)))
                if len(best) > ef:
                    heapq.heappop(best)
    return {i: -nd for nd, i in best}


def build_hnsw(x, m: int = 16, ef_construction: int = 100, seed: int = 0, *,
               device="cuda") -> HnswIndex:
    """Sequential HNSW insertion on the host; the layers land on
    ``device``.  Levels from ``np.random.default_rng(seed)`` capped at 8,
    layer-0 degree 2m, upper layers m (stored padded to 2m)."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    ml = 1.0 / math.log(m)
    levels = np.minimum(
        (-np.log(rng.uniform(size=n, low=1e-12, high=1.0)) * ml).astype(
            np.int64), 8)
    n_layers = int(levels.max()) + 1
    m0 = 2 * m  # layer-0 degree, per the paper
    adj = [np.full((n, m0 if l == 0 else m), INVALID, dtype=np.int32)
           for l in range(n_layers)]
    entry, entry_level = 0, int(levels[0])

    for i in range(1, n):
        li = int(levels[i])
        ep = entry
        # Greedy descent through the layers above li.
        for l in range(entry_level, li, -1):
            if l >= n_layers:
                continue
            improved = True
            while improved:
                improved = False
                for nb in adj[l][ep]:
                    if nb < 0:
                        continue
                    if float((x[nb] - x[i]) @ (x[nb] - x[i])) < float(
                            (x[ep] - x[i]) @ (x[ep] - x[i])):
                        ep = int(nb)
                        improved = True
        # Insert on layers min(li, entry_level) .. 0.
        for l in range(min(li, entry_level), -1, -1):
            found = _search_layer_np(x, adj[l], x[i], ep, ef_construction)
            cap = m0 if l == 0 else m
            nbrs = _select_heuristic(list(found), found, x, cap)
            adj[l][i, :len(nbrs)] = nbrs
            for nb in nbrs:
                row = adj[l][nb]
                slot = (np.argmax(row == INVALID) if (row == INVALID).any()
                        else -1)
                if row[slot] == INVALID and slot != -1:
                    row[slot] = i
                else:
                    # Overfull: re-select among the existing and the new.
                    cand = [int(v) for v in row if v >= 0] + [i]
                    dists = {c: float((x[c] - x[nb]) @ (x[c] - x[nb]))
                             for c in cand}
                    sel = _select_heuristic(cand, dists, x, cap)
                    row[:] = INVALID
                    row[:len(sel)] = sel
            ep = nbrs[0] if nbrs else ep
        if li > entry_level:
            entry, entry_level = i, li

    # Every layer padded to the layer-0 width for one stacked array.
    stacked = np.full((n_layers, n, m0), INVALID, dtype=np.int32)
    for l in range(n_layers):
        stacked[l, :, :adj[l].shape[1]] = adj[l]
    return HnswIndex(layers=torch.from_numpy(stacked).to(dev),
                     entry=torch.tensor(entry, dtype=torch.int32, device=dev),
                     n_layers=n_layers)


def descend(index: HnswIndex, x: torch.Tensor, queries: torch.Tensor,
            counter: dict | None = None) -> torch.Tensor:
    """Greedy descent (beam 1) of every query through layers n_layers-1 ..
    1 from the top entry: (Q,) int32 layer-0 entry points.

    Per layer each lane moves to its nearest valid neighbour (the first on
    ties, INVALID at inf, d2 in the difference form) while that is strictly
    nearer than where it stands; the batch loops until no lane moved, one
    host read of that flag a step, and a lane that stopped stays stopped,
    so each lane takes the reference's ``while_loop`` path.
    ``counter["reads"]`` (if given) gains one a step."""
    q = queries.shape[0]
    ep = index.entry.to(torch.int32).expand(q).contiguous()
    for l in range(index.n_layers - 1, 0, -1):
        layer = index.layers[l]
        moving = torch.ones((q,), dtype=torch.bool, device=queries.device)
        while True:
            nbrs = layer[ep.long()]                        # (Q, 2m)
            valid = nbrs != INVALID
            vecs = x[nbrs.clamp_min(0).long()]
            d = torch.where(valid, ((vecs - queries[:, None, :]) ** 2).sum(-1),
                            torch.inf)
            j = torch.argmin(d, dim=1, keepdim=True)
            d_ep = ((x[ep.long()] - queries) ** 2).sum(-1)
            better = moving & (torch.gather(d, 1, j)[:, 0] < d_ep)
            ep = torch.where(better, torch.gather(nbrs, 1, j)[:, 0], ep)
            moving = better
            if counter is not None:
                counter["reads"] = counter.get("reads", 0) + 1
            if not bool(better.any()):
                break
    return ep


def search_hnsw(index: HnswIndex, x: torch.Tensor, queries: torch.Tensor,
                ef: int, k: int = 10, counter: dict | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, search_mod.SearchStats]:
    """Layered search: the greedy :func:`descend` on the upper layers, then
    a beam of ``ef`` on layer 0 from each query's entry (``max_hops`` 4 ef,
    the exact evaluator: the ``beam_step`` exact kernel on the card).
    Returns (ids, d2, stats): (Q, k), (Q, k) and layer 0's counters."""
    entries = descend(index, x, queries, counter)
    beam_ids, beam_d, stats = search_mod.fixed_search_batch(
        queries, index.layers[0], entries, search_mod._exact_eval(x),
        x.shape[0], ef, 4 * ef)
    return beam_ids[:, :k], beam_d[:, :k], stats
