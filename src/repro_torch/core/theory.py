"""Executable oracles for the paper's §4.2 topology claims (Prop. 4.3); the
port of :mod:`repro.core.theory` (numpy and scipy, copied; the MCGI edges
through the port's :func:`repro_torch.core.prune.robust_prune_batch`).

For small point sets these compute the exact Relative Neighborhood Graph and
Euclidean Minimum Spanning Tree, letting tests assert the inclusion chain

    E_EMST ⊆ E_RNG ⊆ E_MCGI(alpha >= 1, complete candidate pool)

and global connectivity. The chain holds for pruning from *complete*
candidate pools (that is the statement's regime); the practical builder prunes
from greedy-search pools, so the tests exercise :func:`repro_torch.core.prune`
directly on complete pools, plus graph-level connectivity of built indices.
The pruning runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, minimum_spanning_tree

from repro_torch import resolve_device
from repro_torch.core import prune as prune_mod


def pairwise_np(x: np.ndarray) -> np.ndarray:
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    np.fill_diagonal(d2, 0.0)
    return np.maximum(d2, 0.0)


def rng_edges(x: np.ndarray) -> set[tuple[int, int]]:
    """Relative Neighborhood Graph: edge (u,v) iff no witness n has
    max(d(u,n), d(v,n)) < d(u,v).  O(N^3) — test scale only."""
    n = x.shape[0]
    d2 = pairwise_np(x)
    edges = set()
    for u in range(n):
        for v in range(u + 1, n):
            duv = d2[u, v]
            witnesses = np.maximum(d2[u], d2[v]) < duv
            witnesses[u] = witnesses[v] = False
            if not witnesses.any():
                edges.add((u, v))
    return edges


def emst_edges(x: np.ndarray) -> set[tuple[int, int]]:
    d = np.sqrt(pairwise_np(x))
    t = minimum_spanning_tree(csr_matrix(d)).tocoo()
    return {(min(i, j), max(i, j)) for i, j in zip(t.row, t.col)}


def mcgi_complete_pool_edges(
    x: np.ndarray, alpha: np.ndarray, degree: int | None = None,
    device="cuda",
) -> set[tuple[int, int]]:
    """Directed MCGI pruning applied to the *complete* candidate pool of every
    node (the regime of Prop. 4.3), returned as an undirected edge set.

    With degree=None the cap is N-1 (no truncation), which is the pure
    occlusion-rule graph the proposition reasons about.
    """
    n = x.shape[0]
    degree = n - 1 if degree is None else degree
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    cand = node_ids.expand(n, n).contiguous()
    rows, _ = prune_mod.robust_prune_batch(
        xt, node_ids, cand,
        torch.as_tensor(np.asarray(alpha), dtype=torch.float32, device=dev),
        degree,
    )
    rows = rows.cpu().numpy()
    edges = set()
    for u in range(n):
        for v in rows[u]:
            if v >= 0:
                edges.add((min(u, int(v)), max(u, int(v))))
    return edges


def is_connected(n: int, edges: set[tuple[int, int]]) -> bool:
    if not edges:
        return n <= 1
    rows = np.array([e[0] for e in edges] + [e[1] for e in edges])
    cols = np.array([e[1] for e in edges] + [e[0] for e in edges])
    m = csr_matrix((np.ones_like(rows), (rows, cols)), shape=(n, n))
    ncomp, _ = connected_components(m, directed=False)
    return ncomp == 1


def reachable_from(adj: np.ndarray, entry: int) -> np.ndarray:
    """BFS reachability over a directed padded adjacency (navigability check)."""
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    seen[entry] = True
    frontier = [entry]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v >= 0 and not seen[v]:
                    seen[v] = True
                    nxt.append(int(v))
        frontier = nxt
    return seen
