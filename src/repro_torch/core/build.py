"""MCGI index construction — Algorithm 1 (offline) of the paper (port of
:mod:`repro.core.build`).

Phase 1 (Geometric Calibration): LID of every point, population (mu, sigma),
per-node alpha(u) = Phi(LID(u)).

Phase 2 (Manifold-Consistent Refinement): Vamana-style rounds.  Each round
re-wires every node from the beam of a greedy search towards its own vector,
robust-pruned with its own alpha(u); the new edges are mirrored
(reverse-edge insertion with re-pruning of the destinations).

``build_vamana`` is the same procedure with a constant alpha.

Random draws (initial graph, per-round permutations) come from a
``torch.Generator`` seeded with ``cfg.seed``; tests inject the reference's
``init_adj`` and ``perms`` instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import lid as lid_mod
from repro_torch.core import mapping as mapping_mod
from repro_torch.core import prune as prune_mod
from repro_torch.core import search as search_mod
from repro_torch.core.types import GraphIndex

INVALID = -1

# Destinations re-pruned per reverse-insertion call.  Destinations of one
# rewire batch are distinct and each call reads and writes only its own
# rows, so the chunking never changes the result; it bounds the
# (chunk, R + reverse_cap, D) gather.
REVERSE_CHUNK = 32768


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Construction hyper-parameters (paper Table 2 naming)."""

    degree: int = 32            # R — max out-degree
    beam_width: int = 64        # L_build — construction beam
    iters: int = 2              # T — refinement rounds
    lid_k: int = 16             # k-NN size for the LID estimator
    alpha_min: float = mapping_mod.ALPHA_MIN
    alpha_max: float = mapping_mod.ALPHA_MAX
    batch: int = 256            # nodes re-wired per step (walk lanes)
    max_hops: int = 256         # search budget during construction
    reverse_cap: int = 16       # reverse-edge candidates accepted per node/step
    seed: int = 0


def _phase_clock(timings: dict | None, device: torch.device):
    """A context factory that adds each phase's wall time (the card
    synchronised at both ends) to ``timings[name]``; free without one."""

    @contextlib.contextmanager
    def phase(name: str):
        if timings is None:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0

    return phase


def random_graph(n: int, degree: int, generator: torch.Generator,
                 chunk: int = 65536) -> torch.Tensor:
    """R-regular random initial graph with duplicate-free rows (a repeated id
    in a row would corrupt the visited bitset) and no self-loops."""
    dev = generator.device
    ids = torch.randint(0, n, (n, degree), generator=generator, device=dev,
                        dtype=torch.int32)
    earlier = torch.ones((degree, degree), dtype=torch.bool,
                         device=dev).tril(-1)
    for s in range(0, n, chunk):
        blk = ids[s:s + chunk]
        u = torch.arange(s, s + blk.shape[0], device=dev,
                         dtype=torch.int32)[:, None]
        blk = torch.where(blk == u, (blk + 1) % n, blk)
        dup = ((blk[:, None, :] == blk[:, :, None]) & earlier).any(-1)
        ids[s:s + chunk] = torch.where(dup, INVALID, blk)
    return ids


def _rewire_batch(x, adj, alpha, entry, node_ids, cfg: BuildConfig,
                  clock=None):
    """Greedy-search each node's own vector on the current graph, pool the
    beam with its current neighbours, robust-prune with alpha(u).
    Returns (new_rows, new_d2): (B, R) each."""
    clock = clock or _phase_clock(None, x.device)
    with clock("rewire_walks"):
        beam_ids, _, _ = search_mod.beam_search_exact(
            x, adj, x[node_ids.long()], entry, beam_width=cfg.beam_width,
            max_hops=cfg.max_hops, k=cfg.beam_width)
    with clock("prune"):
        pool = torch.cat([beam_ids, adj[node_ids.long()]], 1)  # (B, L+R)
        return prune_mod.robust_prune_batch(x, node_ids, pool,
                                            alpha[node_ids.long()],
                                            cfg.degree)


def _reverse_pairs(node_ids: torch.Tensor, new_rows: torch.Tensor, cap: int):
    """Group mirrored edges by destination: every edge (u -> v) proposes
    (v -> u).  Returns (dest (V,) int32 ascending, cand (V, cap) int32) with
    each group's sources in edge order, capped at ``cap`` (overflow dropped),
    INVALID padded — the reference's host loop, vectorised."""
    dev = new_rows.device
    us = node_ids.to(torch.int32).repeat_interleave(new_rows.shape[1])
    vs = new_rows.reshape(-1)
    keep = vs >= 0
    us, vs = us[keep], vs[keep]
    if vs.numel() == 0:
        return (torch.empty((0,), dtype=torch.int32, device=dev),
                torch.empty((0, cap), dtype=torch.int32, device=dev))
    order = torch.argsort(vs, stable=True)
    us, vs = us[order], vs[order]
    dest, counts = torch.unique_consecutive(vs, return_counts=True)
    group = torch.repeat_interleave(
        torch.arange(dest.numel(), device=dev), counts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(vs.numel(), device=dev) - starts[group]
    sel = pos < cap
    cand = torch.full((dest.numel(), cap), INVALID, dtype=torch.int32,
                      device=dev)
    cand[group[sel], pos[sel]] = us[sel]
    return dest.to(torch.int32), cand


def _insert_reverse(x, adj, alpha, dest, cand, cfg: BuildConfig, valid=None):
    """Merge reverse candidates into the destinations' rows, re-pruning each
    with its own alpha(v).  Updates ``adj`` in place and returns it.

    ``valid`` ((B,) bool, optional) marks real lanes of a padded batch;
    masked lanes are not written (the reference scatters them to row N with
    ``mode="drop"``)."""
    pool = torch.cat([adj[dest.long()], cand], 1)
    rows, _ = prune_mod.robust_prune_batch(x, dest, pool, alpha[dest.long()],
                                           cfg.degree)
    if valid is not None:
        dest, rows = dest[valid], rows[valid]
    adj[dest.long()] = rows
    return adj


def build_with_alpha(x: torch.Tensor, alpha: torch.Tensor, cfg: BuildConfig,
                     progress: Callable[[str], None] | None = None,
                     init_adj: torch.Tensor | None = None, perms=None,
                     timings: dict | None = None) -> torch.Tensor:
    """Phase 2 (Manifold-Consistent Refinement) given frozen per-node alpha.

    ``x`` and ``alpha`` are tensors on the build's device.  ``perms`` (one
    permutation of range(N) per round) replaces the generator's draws.  The
    last batch of a round is padded by wrapping around the permutation, as
    in the reference.  ``timings`` (a dict) gains the seconds spent per
    phase: rewire_walks, prune, reverse_insert.
    """
    n, dev = x.shape[0], x.device
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    adj = (random_graph(n, cfg.degree, gen) if init_adj is None
           else torch.as_tensor(init_adj, dtype=torch.int32,
                                device=dev).clone())
    entry = search_mod.medoid(x)
    clock = _phase_clock(timings, dev)
    for it in range(cfg.iters):
        perm = (torch.randperm(n, generator=gen, device=dev) if perms is None
                else torch.as_tensor(perms[it], device=dev)).long()
        for start in range(0, n, cfg.batch):
            node_ids = perm[start:start + cfg.batch]
            if node_ids.numel() < cfg.batch:   # wrap-around pad
                node_ids = torch.cat([node_ids,
                                      perm[:cfg.batch - node_ids.numel()]])
            new_rows, _ = _rewire_batch(x, adj, alpha, entry, node_ids, cfg,
                                        clock)
            with clock("reverse_insert"):
                adj[node_ids] = new_rows
                dest, cand = _reverse_pairs(node_ids, new_rows,
                                            cfg.reverse_cap)
                for ds in range(0, dest.numel(), REVERSE_CHUNK):
                    adj = _insert_reverse(x, adj, alpha,
                                          dest[ds:ds + REVERSE_CHUNK],
                                          cand[ds:ds + REVERSE_CHUNK], cfg)
        if progress:
            progress(f"refinement round {it + 1}/{cfg.iters} done")
    return adj


def build_mcgi(x, cfg: BuildConfig = BuildConfig(), progress=None, *,
               device="cuda", timings: dict | None = None,
               init_adj=None, perms=None) -> GraphIndex:
    """Algorithm 1 — full offline MCGI build (calibration + refinement).
    ``timings`` gains ``lid_knn`` and the phases of
    :func:`build_with_alpha`."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    clock = _phase_clock(timings, dev)
    with clock("lid_knn"):
        profile = lid_mod.estimate_dataset_lid(x, k=cfg.lid_k)
        mapping = mapping_mod.AlphaMapping(
            mu=profile.mu, sigma=profile.sigma, alpha_min=cfg.alpha_min,
            alpha_max=cfg.alpha_max)
        alpha = mapping(profile.lid)
    if progress:
        progress(f"calibration: mu={float(profile.mu):.2f} "
                 f"sigma={float(profile.sigma):.2f}")
    adj = build_with_alpha(x, alpha, cfg, progress, init_adj=init_adj,
                           perms=perms, timings=timings)
    return GraphIndex(adj=adj, entry=search_mod.medoid(x), alpha=alpha,
                      lid=profile.lid, mu=profile.mu, sigma=profile.sigma)


def build_vamana(x, alpha: float = 1.2, cfg: BuildConfig = BuildConfig(),
                 progress=None, *, device="cuda") -> GraphIndex:
    """DiskANN/Vamana baseline: the same pipeline with constant alpha; with
    iters >= 2 the first round runs at alpha = 1, as DiskANN's first pass."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    alpha_arr = mapping_mod.constant_alpha(n, alpha, dev)
    if cfg.iters >= 2:
        adj = build_with_alpha(x, mapping_mod.constant_alpha(n, 1.0, dev),
                               dataclasses.replace(cfg, iters=1), progress)
        adj = build_with_alpha(x, alpha_arr,
                               dataclasses.replace(cfg, iters=cfg.iters - 1),
                               progress, init_adj=adj)
    else:
        adj = build_with_alpha(x, alpha_arr, cfg, progress)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return GraphIndex(adj=adj, entry=search_mod.medoid(x), alpha=alpha_arr,
                      lid=torch.zeros((n,), dtype=torch.float32, device=dev),
                      mu=zero, sigma=zero.clone())


def block_layout(graph: GraphIndex, nodes_per_block: int) -> np.ndarray:
    """Build-time block-aware record layout for the on-disk store: the
    ``slot_of`` permutation of :func:`repro_torch.core.prune
    .greedy_block_pack` over the built graph, for
    ``write_block_store(..., nodes_per_block=, slot_of=)``."""
    return prune_mod.greedy_block_pack(graph.adj.cpu().numpy(),
                                       int(graph.entry), nodes_per_block)
