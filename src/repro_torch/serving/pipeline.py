"""Host-side scheduling for the staged serving pipeline (port of
:mod:`repro.serving.pipeline`).

Partitioning a batch into budget buckets, padding bucket lane counts,
choosing the bucket-ceiling family from the granted-budget histogram, and
reassembling per-bucket results into the original query order.  The device
programs (probe / continue / rerank) live in :mod:`repro_torch.core.search`.

Two gather disciplines: eager (:func:`bucketed_continue`, each bucket pulled
to the host before the next runs) and deferred
(:func:`dispatch_bucketed_continue` + :func:`gather_bucketed_continue`, every
bucket dispatched before any is gathered).  Per-bucket state gathers stay on
the device (``index_select``); the arrays that come out are the same.
"""
from __future__ import annotations

import numpy as np
import torch

# Continue-phase dispatch overhead in modelled lane-hops: one more bucket
# costs one more dispatch + host gather + pad round trip.  A scheduling
# constant, not a measurement.
BUCKET_LAUNCH_COST_HOPS = 512


def pad_bucket_size(n: int, quantum: int = 8) -> int:
    """Round a bucket's lane count up to a multiple of ``quantum``."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def partition_by_bucket(budgets: np.ndarray, ceilings: tuple[int, ...],
                        quantum: int = 8):
    """Group queries by bucket: [(bucket_index, members, padded_members)];
    padding repeats ``members[0]``.  Empty buckets are skipped."""
    ceil_arr = np.asarray(ceilings, dtype=np.int64)
    bucket_idx = np.minimum(
        np.searchsorted(ceil_arr, np.asarray(budgets), side="left"),
        len(ceilings) - 1)
    out = []
    for bi in range(len(ceilings)):
        members = np.nonzero(bucket_idx == bi)[0]
        if members.size == 0:
            continue
        padded = np.concatenate([
            members,
            np.full(pad_bucket_size(members.size, quantum) - members.size,
                    members[0])])
        out.append((bi, members, padded))
    return out


def auto_bucket_ceilings(budgets: np.ndarray, budget_cfg,
                         max_buckets: int = 8, quantum: int = 8,
                         launch_cost_hops: int = BUCKET_LAUNCH_COST_HOPS
                         ) -> tuple[int, ...]:
    """Pick the bucket-ceiling family from the granted-budget histogram.

    The occupied budget values are split into at most ``max_buckets``
    contiguous groups, each with its own largest value as ceiling and cost
    ``padded_lanes * hop_factor * ceiling + launch_cost_hops``; a dynamic
    program finds the cheapest split (ties keep fewer buckets).  A pure
    function of the histogram; scheduling never changes results.
    """
    budgets = np.asarray(budgets)
    values, counts = np.unique(budgets, return_counts=True)
    m = values.size
    if m == 0:
        return (int(budget_cfg.l_max),)
    k_max = min(max_buckets, m)
    csum = np.concatenate([[0], np.cumsum(counts)])

    def group_cost(i: int, j: int) -> float:
        lanes = pad_bucket_size(int(csum[j] - csum[i]), quantum)
        return (lanes * budget_cfg.hop_factor * int(values[j - 1])
                + launch_cost_hops)

    inf = float("inf")
    prev = [inf] * (m + 1)
    prev[0] = 0.0
    cuts: list = [[None] * (m + 1)]
    cuts[0][0] = ()
    best_cost, best_cs = inf, None
    for _k in range(k_max):
        cur = [inf] * (m + 1)
        cur_cuts: list = [None] * (m + 1)
        for j in range(1, m + 1):
            for i in range(j):
                if prev[i] == inf:
                    continue
                c = prev[i] + group_cost(i, j)
                if c < cur[j]:
                    cur[j] = c
                    cur_cuts[j] = cuts[-1][i] + (int(values[j - 1]),)
        cuts.append(cur_cuts)
        prev = cur
        if cur[m] < best_cost:  # strict: ties keep fewer buckets
            best_cost, best_cs = cur[m], cur_cuts[m]
    return best_cs


def bucketed_continue(continue_fn, probe_state, ctxs, budgets, hop_limits,
                      ceilings: tuple[int, ...]):
    """Budget-bucketed continue phase over one batch, eager discipline.

    Budgets and hop limits pass through unquantized, so every lane computes
    what the unbucketed path would.  Returns (beam_ids, beam_d, hops, evals)
    as numpy, original query order."""
    q = ctxs.shape[0]
    out = None
    for _bi, members, padded in partition_by_bucket(
            budgets.cpu().numpy(), ceilings):
        handles = _dispatch_bucket(continue_fn, probe_state, ctxs, budgets,
                                   hop_limits, padded)
        out = _scatter_bucket(out, q, members, handles)
    if out is None:   # zero-query batch: a zero-lane program gives the shapes
        members, handles = _zero_lane_bucket(continue_fn, probe_state, ctxs,
                                             budgets, hop_limits)
        out = _scatter_bucket(out, q, members, handles)
    return out


def dispatch_bucketed_continue(continue_fn, probe_state, ctxs, budgets,
                               hop_limits, ceilings: tuple[int, ...],
                               budgets_np: np.ndarray | None = None,
                               quantum: int = 8):
    """Dispatch half of the deferred discipline: partition the batch and run
    every bucket's continue program.  Returns [(members, device handles)]."""
    if budgets_np is None:
        budgets_np = budgets.cpu().numpy()
    dispatched = [
        (members, _dispatch_bucket(continue_fn, probe_state, ctxs, budgets,
                                   hop_limits, padded))
        for _bi, members, padded in partition_by_bucket(budgets_np, ceilings,
                                                        quantum)]
    if not dispatched:
        dispatched = [_zero_lane_bucket(continue_fn, probe_state, ctxs,
                                        budgets, hop_limits)]
    return dispatched


def gather_bucketed_continue(q: int, dispatched):
    """Gather half: pull every bucket to the host, reassemble query order."""
    out = None
    for members, handles in dispatched:
        out = _scatter_bucket(out, q, members, handles)
    if out is None:
        raise ValueError("no buckets dispatched")
    return out


def _dispatch_bucket(continue_fn, probe_state, ctxs, budgets, hop_limits,
                     padded: np.ndarray):
    sel = torch.as_tensor(padded, dtype=torch.long, device=ctxs.device)
    sub_state = tuple(a.index_select(0, sel) for a in probe_state)
    return continue_fn(sub_state, ctxs.index_select(0, sel),
                       budgets.index_select(0, sel),
                       hop_limits.index_select(0, sel))


def _zero_lane_bucket(continue_fn, probe_state, ctxs, budgets, hop_limits):
    none = np.empty((0,), np.int64)
    return none, _dispatch_bucket(continue_fn, probe_state, ctxs, budgets,
                                  hop_limits, none)


def _scatter_bucket(out, q: int, members, handles):
    """Pull one bucket's results to the host and place them at their batch
    positions, dropping the padding lanes."""
    host = [h.cpu().numpy() for h in handles]
    if out is None:
        out = tuple(np.empty((q,) + h.shape[1:], dtype=h.dtype) for h in host)
    m = members.size
    for buf, h in zip(out, host):
        buf[members] = h[:m]
    return out
