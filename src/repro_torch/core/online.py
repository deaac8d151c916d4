"""Online-MCGI — Algorithm 2 of the paper (port of :mod:`repro.core.online`).

Differences from the offline Algorithm 1 (:mod:`repro_torch.core.build`):

* Phase 1 only *bootstraps* the population statistics (mu, sigma) from a
  random sample (:func:`repro_torch.core.lid.bootstrap_stats`) instead of
  estimating the LID of every point;
* during refinement each node's LID is estimated on the fly from its own
  search beam, and alpha(u) is recomputed from it every round.

Random draws come from one ``torch.Generator`` seeded with ``cfg.seed``, in
this order: the bootstrap sample, the initial graph, then one permutation
per round.  Tests inject the reference's draws (``sample_idx``,
``init_adj``, ``perms``) instead; an injected draw takes nothing from the
generator.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import build as build_mod
from repro_torch.core import lid as lid_mod
from repro_torch.core import mapping as mapping_mod
from repro_torch.core import prune as prune_mod
from repro_torch.core import search as search_mod
from repro_torch.core.types import GraphIndex

INVALID = build_mod.INVALID


def _rewire_batch_online(x, adj, mu, sigma, entry, node_ids,
                         cfg: build_mod.BuildConfig, clock=None):
    """One online refinement step: walk -> online LID -> alpha(u) -> prune.

    The walk is one :func:`repro_torch.core.search.beam_search_exact` (one
    ``beam_walk`` launch on the card); the node itself and INVALID slots
    leave its LID neighbourhood.  Returns (new_rows, new_d2, alpha_u,
    lid_u) for the batch.
    """
    clock = clock or build_mod._phase_clock(None, x.device)
    nodes = node_ids.long()
    with clock("rewire_walks"):
        beam_ids, beam_d2, _ = search_mod.beam_search_exact(
            x, adj, x[nodes], entry, beam_width=cfg.beam_width,
            max_hops=cfg.max_hops, k=cfg.beam_width)
    with clock("prune"):
        drop = (beam_ids == nodes[:, None]) | (beam_ids == INVALID)
        d2 = torch.where(drop, torch.inf, beam_d2)
        lid_u = lid_mod.online_lid(d2, k=min(cfg.lid_k, cfg.beam_width))
        alpha_u = mapping_mod.phi(lid_u, mu, sigma, cfg.alpha_min,
                                  cfg.alpha_max)
        pool = torch.cat([beam_ids, adj[nodes]], 1)
        rows, rows_d2 = prune_mod.robust_prune_batch(x, node_ids, pool,
                                                     alpha_u, cfg.degree)
    return rows, rows_d2, alpha_u, lid_u


def _wire(x, adj, alpha, lid, mu, sigma, entry, node_ids,
          cfg: build_mod.BuildConfig, clock) -> None:
    """Rewire ``node_ids`` (distinct, real lanes only) and mirror their new
    edges, writing ``adj``, ``alpha`` and ``lid`` in place.

    The batch's rows, alpha and LID are written before the reverse pass
    reads alpha.  The reference wrap-pads a short batch to its jitted shape
    and scatters only the real prefix; lanes are independent, so walking the
    real ids alone gives the same rows without duplicate scatter indices
    (whose winner CUDA leaves undefined).  Destinations of one batch are
    distinct, so the reverse pass's chunking never changes the result."""
    rows, _, alpha_u, lid_u = _rewire_batch_online(x, adj, mu, sigma, entry,
                                                   node_ids, cfg, clock)
    with clock("reverse_insert"):
        nodes = node_ids.long()
        adj[nodes] = rows
        alpha[nodes] = alpha_u
        lid[nodes] = lid_u
        dest, cand = build_mod._reverse_pairs(node_ids, rows,
                                              cfg.reverse_cap)
        for ds in range(0, dest.numel(), build_mod.REVERSE_CHUNK):
            build_mod._insert_reverse(x, adj, alpha,
                                      dest[ds:ds + build_mod.REVERSE_CHUNK],
                                      cand[ds:ds + build_mod.REVERSE_CHUNK],
                                      cfg)


def build_online_mcgi(x, cfg: build_mod.BuildConfig = build_mod.BuildConfig(),
                      sample: int = 2048, progress=None, *, device="cuda",
                      timings: dict | None = None, init_adj=None, perms=None,
                      sample_idx=None) -> GraphIndex:
    """Algorithm 2: bootstrap (mu, sigma), then refine every node with its
    on-the-fly LID.  Un-refined nodes hold the midpoint alpha and LID mu.

    ``timings`` (a dict) gains the seconds of each phase: bootstrap,
    rewire_walks, prune, reverse_insert.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    clock = build_mod._phase_clock(timings, dev)
    with clock("bootstrap"):
        mu, sigma = lid_mod.bootstrap_stats(x, gen, sample=sample,
                                            k=cfg.lid_k,
                                            sample_idx=sample_idx)
    if progress:
        progress(f"bootstrap: mu={float(mu):.2f} sigma={float(sigma):.2f}")
    adj = (build_mod.random_graph(n, cfg.degree, gen) if init_adj is None
           else torch.as_tensor(init_adj, dtype=torch.int32,
                                device=dev).clone())
    entry = search_mod.medoid(x)
    alpha = torch.full((n,), 0.5 * (cfg.alpha_min + cfg.alpha_max),
                       dtype=torch.float32, device=dev)
    lid = mu.expand(n).clone()
    for it in range(cfg.iters):
        perm = (torch.randperm(n, generator=gen, device=dev) if perms is None
                else torch.as_tensor(perms[it], device=dev)).long()
        for start in range(0, n, cfg.batch):
            _wire(x, adj, alpha, lid, mu, sigma, entry,
                  perm[start:start + cfg.batch], cfg, clock)
        if progress:
            progress(f"online refinement round {it + 1}/{cfg.iters} done")
    return GraphIndex(adj=adj, entry=entry, alpha=alpha, lid=lid, mu=mu,
                      sigma=sigma)
