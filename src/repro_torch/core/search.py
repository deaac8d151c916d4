"""Batched greedy beam search over a proximity graph (port of
:mod:`repro.core.search`).

The beam is a fixed-shape (Q, L) state, the visited set a bitmask of
(Q, ceil(N/32)) int32 words holding uint32 bit patterns, and the hop loop a
Python loop over the whole batch that freezes converged lanes — the form XLA
gives the reference's vmapped ``while_loop``.

Two distance regimes:
  * exact     — full-precision vectors steer the walk;
  * PQ-routed — ADC distances from per-query LUTs steer the walk and the
    final beam is reranked with full-precision vectors.

Every walk runs through :func:`run_batch`: one
:func:`repro_torch.kernels.ops.beam_walk` per batch, which walks every lane
to convergence (the port of ``repro``'s ``PallasBeamStep.run_batch``, whose
host loop makes one kernel call per hop).  The wrapper dispatches by the
tensors' device only — one launch of the hand-written CUDA kernel on the
card, its plain version (``beam_step_ref`` iterated) on the CPU — so the
CPU tests drive the same call the card runs.

The out-of-core walk keeps no adjacency on the card: :func:`ooc_select_pq`
and :func:`ooc_hop_pq` are one :func:`repro_torch.kernels.ops.beam_hop_rows`
each (a launch of the row-fed hop on the card), and the host loop of
:func:`repro_torch.index.disk.ooc_walk` reads each hop's rows from the block
store between them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import lid as lid_mod
from repro_torch.core import mapping as mapping_mod
from repro_torch.kernels import ops

INVALID = -1

# eval_dists(ctxs (Q, ...), ids (Q, R) int, valid (Q, R) bool) -> (Q, R).
DistEval = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Per-query work counters (the paper's resource-efficiency metrics)."""

    hops: torch.Tensor        # nodes expanded == slow-tier reads
    dist_evals: torch.Tensor  # distance computations


@dataclasses.dataclass(frozen=True)
class AdaptiveBeamBudget:
    """Serve-time configuration of Prop. 4.2's per-query budget law (see
    :class:`repro.core.search.AdaptiveBeamBudget`): a probe at ``l_min``
    width, an online LID estimate, a budget in [l_min, l_max] and a hop limit
    of ``probe_hops + hop_factor * budget``; ``center=None`` centres the LID
    on the batch mean."""

    l_min: int
    l_max: int
    lam: float = 0.15
    lid_k: int = 16
    probe_hops: int = 8
    hop_factor: int = 4
    center: float | None = None

    def __post_init__(self):
        if not 0 < self.l_min <= self.l_max:
            raise ValueError((self.l_min, self.l_max))
        if self.probe_hops < 1 or self.hop_factor < 1:
            raise ValueError((self.probe_hops, self.hop_factor))


@dataclasses.dataclass(frozen=True)
class AdaptiveStats:
    """Per-query adaptivity diagnostics returned by the adaptive engine."""

    q_lid: torch.Tensor   # (Q,) online LID estimate from the probe beam
    budget: torch.Tensor  # (Q,) int32 beam budget actually granted


def _bits(ids: torch.Tensor) -> torch.Tensor:
    """The visited-word bit of each (non-negative) node id, int32 pattern."""
    return torch.bitwise_left_shift(torch.ones_like(ids), ids & 31)


class _ExactEval:
    """Full-precision squared-L2 evaluator; ``kind``/``table`` let the fused
    step read the table itself."""

    kind = "exact"

    def __init__(self, x: torch.Tensor):
        self.table = x

    def __call__(self, ctxs, ids, valid):
        diff = self.table[ids.long()] - ctxs[:, None, :]
        return (diff * diff).sum(-1)


class _PqEval:
    """ADC evaluator over PQ codes; each lane's context is its (M, K) LUT."""

    kind = "pq"

    def __init__(self, codes: torch.Tensor):
        self.table = codes

    def __call__(self, luts, ids, valid):
        c = self.table[ids.long()].long()                   # (Q, R, M)
        return torch.gather(luts, 2, c.transpose(1, 2)).sum(1)


def _exact_eval(x: torch.Tensor) -> DistEval:
    return _ExactEval(x)


def _pq_eval(codes: torch.Tensor) -> DistEval:
    return _PqEval(codes)


def _init_state(ctxs: torch.Tensor, entry, eval_dists: DistEval, n: int,
                beam_width: int, excl_words: torch.Tensor | None = None):
    """Fresh search state for every lane: the entry node in beam slot 0 and
    its visited bit set.  ``entry`` is one node for every lane or a (Q,)
    vector of one a lane (HNSW's layer 0 starts each query where its
    descent ended).  ``excl_words`` ((Q, ceil(n/32)) int32, from
    :func:`pack_filter`) pre-seeds the visited set with a per-query filter;
    an excluded entry gets distance inf (traversed through, scrubbed at
    exit).  Nothing here reads the device from the host."""
    q, dev = ctxs.shape[0], ctxs.device
    nw = (n + 31) // 32
    entry = torch.as_tensor(entry, dtype=torch.int32, device=dev)
    e = (entry.reshape(()).expand(q) if entry.numel() == 1
         else entry.reshape(q))[:, None]
    entry_d = eval_dists(ctxs, e, torch.ones((q, 1), dtype=torch.bool,
                                             device=dev))[:, 0]
    word, bit = (e >> 5).long(), _bits(e)
    if excl_words is None:
        visited = torch.zeros((q, nw), dtype=torch.int32, device=dev)
        visited.scatter_(1, word, bit)
    else:
        old = torch.gather(excl_words, 1, word)
        entry_d = torch.where((old[:, 0] & bit[:, 0]) != 0, torch.inf,
                              entry_d)
        visited = excl_words.clone()
        visited.scatter_(1, word, old | bit)
    beam_ids = torch.full((q, beam_width), INVALID, dtype=torch.int32,
                          device=dev)
    beam_ids[:, 0] = e[:, 0]
    beam_d = torch.full((q, beam_width), torch.inf, dtype=torch.float32,
                        device=dev)
    beam_d[:, 0] = entry_d
    beam_exp = torch.zeros((q, beam_width), dtype=torch.bool, device=dev)
    zeros = torch.zeros((q,), dtype=torch.int32, device=dev)
    return beam_ids, beam_d, beam_exp, visited, zeros, zeros.clone()


def pack_filter(allowed, n: int, device="cuda") -> torch.Tensor:
    """Pack a boolean *allowed* mask ((n,) or (Q, n)) into (Q, ceil(n/32))
    int32 exclusion words (uint32 bit patterns): bit j of word w set means
    node w*32+j is excluded."""
    allowed = np.atleast_2d(np.asarray(allowed, dtype=bool))
    q, n_mask = allowed.shape
    if n_mask != n:
        raise ValueError(f"filter covers {n_mask} nodes, index has {n}")
    nw = (n + 31) // 32
    padded = np.zeros((q, nw * 32), dtype=bool)
    padded[:, :n] = ~allowed
    bits = padded.reshape(q, nw, 32).astype(np.uint32)
    words = (bits << np.arange(32, dtype=np.uint32)).sum(axis=2,
                                                         dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(resolve_device(device))


def scrub_excluded(beam_ids, beam_d, excl_words):
    """Drop excluded ids (the force-seeded entry) from final beams."""
    safe = beam_ids.clamp_min(0)
    words = torch.gather(excl_words, 1, (safe >> 5).long())
    blocked = (beam_ids != INVALID) & ((words & _bits(safe)) != 0)
    return (torch.where(blocked, INVALID, beam_ids),
            torch.where(blocked, torch.inf, beam_d))


def _scrub_state(state, excl_words):
    ids, d = scrub_excluded(state[0], state[1], excl_words)
    return (ids, d) + tuple(state[2:])


def _lane_vector(v, q: int, device) -> torch.Tensor:
    """(Q,) int32 on ``device`` from a per-lane array or one number; a
    number is filled on the device (no host-to-device copy, so no wait for
    the stream)."""
    if isinstance(v, (int, np.integer)):
        return torch.full((q,), int(v), dtype=torch.int32, device=device)
    return torch.as_tensor(v, dtype=torch.int32,
                           device=device).expand(q).contiguous()


def _lane_vectors(q: int, beam_width: int, hop_limits, budgets, device):
    return (_lane_vector(beam_width if budgets is None else budgets, q,
                         device),
            _lane_vector(hop_limits, q, device))


def check_converged(active_count: torch.Tensor) -> None:
    """Read a walk's movable-lane counter (:func:`run_batch`'s
    ``active_count``): a walk to convergence must leave 0."""
    left = int(active_count)
    if left != 0:
        raise RuntimeError(f"{left} lanes could still move after a walk "
                           f"to convergence")


def run_batch(states, ctxs, adj, eval_dists: DistEval, beam_width: int,
              hop_limits, budgets=None, active_count=None):
    """Run a batch of lanes to convergence, freezing each lane whose loop
    condition is False (hop limit reached or frontier closed) exactly as the
    reference's vmapped ``while_loop``; leaves of ``states`` are (Q, ...),
    with per-lane ``hop_limits`` and optional ``budgets``.

    The state is cloned once at entry (the kernel updates it in place, and
    callers such as the engine's partial results keep the input state), then
    walked by one :func:`ops.beam_walk` with no hop cap.  The walk counts
    the lanes that could still move at its end; the one read of that
    counter must give 0 (:func:`check_converged`).  ``active_count`` (one
    int32 on the states' device) takes that count instead and leaves the
    read to the caller, so the call returns without waiting for the walk.
    ``eval_dists`` must be one of :func:`_exact_eval` / :func:`_pq_eval`,
    whose table the walk reads.
    """
    kind = getattr(eval_dists, "kind", None)
    table = getattr(eval_dists, "table", None)
    if kind not in ("exact", "pq") or table is None:
        raise ValueError("the hop loop needs an exact or PQ evaluator "
                         "(_exact_eval / _pq_eval), got "
                         f"{type(eval_dists).__name__}")
    q, dev = states[0].shape[0], states[0].device
    b, hl = _lane_vectors(q, beam_width, hop_limits, budgets, dev)
    st = tuple(t.clone() for t in states)
    if q == 0:
        return st
    left = (torch.zeros((1,), dtype=torch.int32, device=dev)
            if active_count is None else active_count)
    st = ops.beam_walk(st, ctxs.contiguous(), adj, table, b, hl, kind=kind,
                       max_hops=ops.MAX_HOPS, active_count=left)
    if active_count is None:
        check_converged(left)
    return st


def fixed_search_batch(ctxs, adj, entry, eval_dists: DistEval, n: int,
                       beam_width: int, max_hops: int, excl=None,
                       active_count=None):
    """Batched fixed-beam walk: init every lane (``entry`` one node or one a
    lane), hand the batch to :func:`run_batch`; ``excl`` filters the walk
    in-graph.
    ``active_count``: see :func:`run_batch`."""
    states = _init_state(ctxs, entry, eval_dists, n, beam_width, excl)
    beam_ids, beam_d, _, _, hops, evals = run_batch(
        states, ctxs, adj, eval_dists, beam_width, max_hops,
        active_count=active_count)
    if excl is not None:
        beam_ids, beam_d = scrub_excluded(beam_ids, beam_d, excl)
    return beam_ids, beam_d, SearchStats(hops=hops, dist_evals=evals)


# --------------------------------------------------------------------------
# Out-of-core walk programs (the reference's ``ooc_*``): the in-memory walk's
# per-lane ops split at the frontier selection, so the host can read each
# hop's adjacency rows from the block store between two device calls:
#
#     select:  (state)            -> (state', u, active)      [device]
#     fetch:   rows = adj[u]      via BlockSlowTier           [host  ]
#     hop:     (state', u, rows)  -> expand, then next select [device]
#
# Both device calls are ops.beam_hop_rows (the select: every lane inactive).
# Per lane they run the walk's ops in the walk's order, so an out-of-core
# walk is bit-identical to the in-memory one.


def ooc_init_pq(codes, ctxs, entry, n: int, beam_width: int, excl=None):
    """Fresh lane states for a PQ-steered out-of-core walk: the entry's ADC
    distance from the device-resident codes; ``excl`` pre-seeds the
    visited sets with the filter, as :func:`fixed_search_batch` does."""
    return _init_state(ctxs, entry, _pq_eval(codes), n, beam_width, excl)


def ooc_select_pq(states, budgets, hop_limits, beam_width: int):
    """The first frontier of an out-of-core walk segment: returns
    ``(states, u, active)``, with ``u`` INVALID on lanes whose loop
    condition is already False (no read is issued for them); the selection
    is marked on active lanes only.  On the card ``states`` is updated in
    place."""
    if states[0].shape[1] != beam_width:
        raise ValueError(f"beam width {states[0].shape[1]} != {beam_width}")
    return ops.beam_hop_rows(states, None, None, None, None, None, budgets,
                             hop_limits, kind="pq")


def ooc_hop_pq(codes, states, u, active, rows, ctxs, budgets, hop_limits,
               beam_width: int):
    """One out-of-core hop: each active lane expands its selected frontier
    ``u`` with ``rows`` (Q, R) int32 (= ``adj[u]``; host numpy or a tensor,
    copied to the states' device on the current stream), then selects the
    next.  Returns ``(states, u_next, active_next)`` as
    :func:`ooc_select_pq` does."""
    if states[0].shape[1] != beam_width:
        raise ValueError(f"beam width {states[0].shape[1]} != {beam_width}")
    rows = torch.as_tensor(rows, dtype=torch.int32, device=states[0].device)
    return ops.beam_hop_rows(states, u, active, rows, ctxs, codes, budgets,
                             hop_limits, kind="pq")


def budget_bucket_ceilings(l_min: int, l_max: int,
                           max_buckets: int = 4) -> tuple[int, ...]:
    """Halving budget ceilings covering [l_min, l_max], ascending, the last
    always ``l_max``.  E.g. (16, 96, 4) -> (16, 24, 48, 96)."""
    if max_buckets < 1 or not 0 < l_min <= l_max:
        raise ValueError((l_min, l_max, max_buckets))
    cs = [int(l_max)]
    while len(cs) < max_buckets and cs[-1] > int(l_min):
        cs.append(max(int(l_min), cs[-1] // 2))
    return tuple(sorted(set(cs)))


def quantize_budgets(budgets: torch.Tensor, ceilings: tuple[int, ...]):
    """Round each budget *up* to its bucket ceiling: (bucket_index, budget),
    the first ascending ceiling >= the budget (the last one past them all).
    The ceilings enter as numbers, so nothing is copied to the device (a
    copy from pageable memory would wait for the stream)."""
    b = budgets.to(torch.int32)
    last = len(ceilings) - 1
    idx = torch.full(b.shape, last, dtype=torch.int64, device=b.device)
    out = torch.full_like(b, int(ceilings[last]))
    for i in range(last, -1, -1):
        fits = b <= int(ceilings[i])
        idx = torch.where(fits, i, idx)
        out = torch.where(fits, int(ceilings[i]), out)
    return idx, out


def _bucket_hop_limits(budget_cfg: AdaptiveBeamBudget, budgets, max_hops):
    """Per-query hop limit = probe + hop_factor * budget, SLO-capped."""
    hop_limits = (budget_cfg.probe_hops
                  + budget_cfg.hop_factor * budgets).to(torch.int32)
    if max_hops is not None:
        hop_limits = hop_limits.clamp_max(int(max_hops))
    return hop_limits


def grant_budgets(probe_state, budget_cfg: AdaptiveBeamBudget,
                  max_hops: int | None = None, *, lam=None, l_min=None):
    """LID estimate + budget grant from a finished probe state.  Returns
    ``(budgets, hop_limits, q_lid)``."""
    lam_ = budget_cfg.lam if lam is None else lam
    l_min_ = budget_cfg.l_min if l_min is None else l_min
    p_ids, p_d = probe_state[0], probe_state[1]
    d_pool = torch.where(p_ids == INVALID, torch.inf, p_d)
    q_lid = lid_mod.online_lid(d_pool, k=min(budget_cfg.lid_k,
                                             budget_cfg.l_max))
    center = (torch.full((), budget_cfg.center, dtype=torch.float32,
                         device=q_lid.device)
              if budget_cfg.center is not None else q_lid.mean())
    budgets = mapping_mod.adaptive_beam_budget(
        q_lid, lam_, l_min_, budget_cfg.l_max, mu=center)
    return budgets, _bucket_hop_limits(budget_cfg, budgets, max_hops), q_lid


def adaptive_probe_batch(ctxs, adj, entry, eval_dists: DistEval, n: int,
                         budget_cfg: AdaptiveBeamBudget,
                         max_hops: int | None = None, *, lam=None, l_min=None,
                         excl=None, active_count=None):
    """Phases 1-2 of the adaptive engine: ``probe_hops`` hops at ``l_min``
    frontier budget into an ``l_max``-wide beam, then the budget grant.
    Returns (probe_state, budgets, hop_limits, q_lid); a filtered probe state
    is already scrubbed of the forced entry seed.  ``active_count``: see
    :func:`run_batch` (given, nothing here waits for the device)."""
    l_max = budget_cfg.l_max
    l_min_ = budget_cfg.l_min if l_min is None else l_min
    states = _init_state(ctxs, entry, eval_dists, n, l_max, excl)
    probe_state = run_batch(states, ctxs, adj, eval_dists, l_max,
                            hop_limits=budget_cfg.probe_hops, budgets=l_min_,
                            active_count=active_count)
    if excl is not None:
        probe_state = _scrub_state(probe_state, excl)
    budgets, hop_limits, q_lid = grant_budgets(
        probe_state, budget_cfg, max_hops, lam=lam, l_min=l_min)
    return probe_state, budgets, hop_limits, q_lid


def adaptive_continue_batch(probe_state, ctxs, adj, eval_dists: DistEval,
                            budget_cfg: AdaptiveBeamBudget, budgets,
                            hop_limits, active_count=None):
    """Phase 3: resume the probe states with per-query budgets and hop
    limits.  Returns (beam_ids, beam_d, hops, evals), counters including the
    probe.  ``active_count``: see :func:`run_batch`."""
    beam_ids, beam_d, _, _, hops, evals = run_batch(
        probe_state, ctxs, adj, eval_dists, budget_cfg.l_max,
        hop_limits=hop_limits, budgets=budgets, active_count=active_count)
    return beam_ids, beam_d, hops, evals


def adaptive_search_batch(ctxs, adj, entry, eval_dists: DistEval, n: int,
                          budget_cfg: AdaptiveBeamBudget,
                          max_hops: int | None = None,
                          bucket_ceilings: tuple[int, ...] | None = None, *,
                          lam=None, l_min=None, excl=None, active_count=None):
    """Probe -> budget -> continue in one call.  ``bucket_ceilings``
    quantizes each budget up to its ceiling and derives the hop limit from
    it.  Returns (beam_ids, beam_d, stats, adaptive_stats).
    ``active_count`` takes both walks' counters (see :func:`run_batch`)."""
    probe_state, budgets, hop_limits, q_lid = adaptive_probe_batch(
        ctxs, adj, entry, eval_dists, n, budget_cfg, max_hops, lam=lam,
        l_min=l_min, excl=excl, active_count=active_count)
    if bucket_ceilings is not None:
        _, budgets = quantize_budgets(budgets, bucket_ceilings)
        hop_limits = _bucket_hop_limits(budget_cfg, budgets, max_hops)
    beam_ids, beam_d, hops, evals = adaptive_continue_batch(
        probe_state, ctxs, adj, eval_dists, budget_cfg, budgets, hop_limits,
        active_count=active_count)
    return (beam_ids, beam_d, SearchStats(hops=hops, dist_evals=evals),
            AdaptiveStats(q_lid=q_lid, budget=budgets))


def beam_search_exact(x, adj, queries, entry, beam_width: int,
                      max_hops: int = 2048, k: int = 10, excl=None,
                      active_count=None):
    """Exact-distance beam search over (Q, D) queries: (ids, d2, stats),
    (Q, k) ascending.  ``excl`` (from :func:`pack_filter`) filters
    in-graph; ``active_count``: see :func:`run_batch`."""
    beam_ids, beam_d, stats = fixed_search_batch(
        queries, adj, entry, _exact_eval(x), x.shape[0], beam_width,
        max_hops, excl=excl, active_count=active_count)
    return beam_ids[:, :k], beam_d[:, :k], stats


def beam_search_pq(codes, luts, x_slow, adj, queries, entry, beam_width: int,
                   max_hops: int = 2048, k: int = 10, rerank: bool = True,
                   excl=None, active_count=None):
    """PQ-routed beam search (codes (N, M) uint8, luts (Q, M, K)) with an
    optional full-precision rerank of the final beam from ``x_slow``."""
    beam_ids, beam_d, stats = fixed_search_batch(
        luts, adj, entry, _pq_eval(codes), codes.shape[0], beam_width,
        max_hops, excl=excl, active_count=active_count)
    if rerank:
        ids, d2 = _rerank_slow_tier(beam_ids, x_slow, queries, k)
        return ids, d2, stats
    return beam_ids[:, :k], beam_d[:, :k], stats


def _rerank_slow_tier(beam_ids, x_slow, queries, k: int):
    """Full-precision rerank of the final beam (one batched slow-tier read)."""
    return _rerank_from_vecs(beam_ids, x_slow[beam_ids.clamp_min(0).long()],
                             queries, k)


def _rerank_from_vecs(beam_ids, vecs, queries, k: int):
    """Rerank from gathered beam vectors (Q, L, D): exact d2, INVALID at inf,
    stable ascending top-k."""
    diff = vecs - queries[:, None, :]
    d2 = torch.where(beam_ids == INVALID, torch.inf, (diff * diff).sum(-1))
    order = torch.argsort(d2, dim=1, stable=True)[:, :k]
    return torch.gather(beam_ids, 1, order), torch.gather(d2, 1, order)


def _probe_exact(x, adj, queries, entry, budget_cfg, excl=None,
                 active_count=None):
    return adaptive_probe_batch(queries, adj, entry, _exact_eval(x),
                                x.shape[0], budget_cfg, excl=excl,
                                active_count=active_count)


def _continue_exact(x, adj, probe_state, ctxs, budgets, hop_limits,
                    budget_cfg):
    return adaptive_continue_batch(probe_state, ctxs, adj, _exact_eval(x),
                                   budget_cfg, budgets, hop_limits)


def _probe_pq(codes, adj, luts, entry, budget_cfg, excl=None,
              active_count=None):
    return adaptive_probe_batch(luts, adj, entry, _pq_eval(codes),
                                codes.shape[0], budget_cfg, excl=excl,
                                active_count=active_count)


def _continue_pq(codes, adj, probe_state, luts, budgets, hop_limits,
                 budget_cfg):
    return adaptive_continue_batch(probe_state, luts, adj, _pq_eval(codes),
                                   budget_cfg, budgets, hop_limits)


def _bucketed_continue(continue_fn, probe_state, ctxs, budgets, hop_limits,
                       ceilings):
    """Budget-bucketed continue phase through the serving scheduler (eager
    discipline); returns tensors on the inputs' device, original order."""
    from repro_torch.serving import pipeline as pipe

    out = pipe.bucketed_continue(continue_fn, probe_state, ctxs, budgets,
                                 hop_limits, ceilings)
    return tuple(torch.from_numpy(a).to(ctxs.device) for a in out)


def beam_search_exact_adaptive(x, adj, queries, entry,
                               budget_cfg: AdaptiveBeamBudget, k: int = 10,
                               num_buckets: int | None = None, excl=None):
    """Exact-distance adaptive-beam search (probe -> budget -> continue);
    ``num_buckets`` >= 2 runs the continue phase budget-bucketed (same
    results).  Returns (ids, d2, stats, adaptive_stats)."""
    if num_buckets is None or num_buckets <= 1:
        beam_ids, beam_d, stats, astats = adaptive_search_batch(
            queries, adj, entry, _exact_eval(x), x.shape[0], budget_cfg,
            excl=excl)
        return beam_ids[:, :k], beam_d[:, :k], stats, astats
    probe_state, budgets, hop_limits, q_lid = _probe_exact(
        x, adj, queries, entry, budget_cfg, excl=excl)
    ceilings = budget_bucket_ceilings(budget_cfg.l_min, budget_cfg.l_max,
                                      num_buckets)

    def cont(st, c, b, h):
        return _continue_exact(x, adj, st, c, b, h, budget_cfg)

    beam_ids, beam_d, hops, evals = _bucketed_continue(
        cont, probe_state, queries, budgets, hop_limits, ceilings)
    return (beam_ids[:, :k], beam_d[:, :k],
            SearchStats(hops=hops, dist_evals=evals),
            AdaptiveStats(q_lid=q_lid, budget=budgets))


def beam_search_pq_adaptive(codes, luts, x_slow, adj, queries, entry,
                            budget_cfg: AdaptiveBeamBudget, k: int = 10,
                            rerank: bool = True,
                            num_buckets: int | None = None, excl=None):
    """PQ-routed adaptive-beam search + optional full-precision rerank;
    shapes as :func:`beam_search_pq`, buckets as
    :func:`beam_search_exact_adaptive`."""
    if num_buckets is None or num_buckets <= 1:
        beam_ids, beam_d, stats, astats = adaptive_search_batch(
            luts, adj, entry, _pq_eval(codes), codes.shape[0], budget_cfg,
            excl=excl)
    else:
        probe_state, budgets, hop_limits, q_lid = _probe_pq(
            codes, adj, luts, entry, budget_cfg, excl=excl)
        ceilings = budget_bucket_ceilings(budget_cfg.l_min, budget_cfg.l_max,
                                          num_buckets)

        def cont(st, c, b, h):
            return _continue_pq(codes, adj, st, c, b, h, budget_cfg)

        beam_ids, beam_d, hops, evals = _bucketed_continue(
            cont, probe_state, luts, budgets, hop_limits, ceilings)
        stats = SearchStats(hops=hops, dist_evals=evals)
        astats = AdaptiveStats(q_lid=q_lid, budget=budgets)
    if rerank:
        ids, d2 = _rerank_slow_tier(beam_ids, x_slow, queries, k)
        return ids, d2, stats, astats
    return beam_ids[:, :k], beam_d[:, :k], stats, astats


def medoid(x: torch.Tensor) -> torch.Tensor:
    """Entry point: the point closest to the dataset centroid (int32)."""
    diff = x - x.mean(0, keepdim=True)
    return torch.argmin((diff * diff).sum(-1)).to(torch.int32)
