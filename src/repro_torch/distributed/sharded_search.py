"""Distributed MCGI serving: sharded beam search and a global top-k merge
(port of :mod:`repro.distributed.sharded_search`).

Layout: the base points are split into ``n_shards`` partitions, shard-major
(shard ``s`` owns rows ``[s*per, (s+1)*per)`` of ``adj``, ``codes`` and
``vectors``); every shard holds its own locally built MCGI sub-graph (with
shard-local ids), its PQ codes and its full-precision rows.  A query fans
out to every shard, each runs the PQ-routed (or exact) beam search and a
local exact rerank on its sub-index, and the per-shard top-k are merged into
the global top-k.

The port is single-controller, as the reference is: one process drives
every shard of a :class:`repro_torch.distributed.mesh.ShardMesh`, whose
shards are spread over its devices (every visible card by default).  An
index on a mesh of several devices is held as
:class:`~repro_torch.distributed.mesh.ShardedRows`, each shard's rows on
its own card (:func:`place_arrays`); a one-device mesh takes shard-major
tensors.  Each shard's walk is one :func:`repro_torch.core.search
.run_batch` (one ``ops.beam_walk`` launch on the card) over its own rows,
queued on the shard's own stream behind the caller's stream, so the shards'
walks overlap and the host waits for none of them.  Each shard's frontier
state stays on its card (:class:`~repro_torch.distributed.mesh
.ShardStack`); its ``(Q, k)`` candidates are copied to the mesh's first
device, which waits for the shards' streams (the reference's
``all_gather``), and the hedged merge runs there; the reference's ``psum``
is a sum over the gathered shards.

Straggler mitigation: the merge takes a per-shard ``shard_ok`` mask; a shard
that is late or down contributes +inf distances, so the merge degrades
(recall loss about its data fraction) instead of stalling the query.  The
mask is a runtime input.

Two execution shapes, as in the reference:

* the **monolithic step** (:func:`make_distributed_search`): probe, budget,
  continue, local rerank and hedged merge in one call;
* the **staged step** (:func:`make_distributed_probe` +
  :func:`make_distributed_continue`): the same walk split at the probe
  horizon.  The probe checkpoints every shard's frontier (beam, visited
  words, counters) laid out ``(Q, n_shards, ...)`` so the host schedules on
  the query axis, and grants per-shard budgets; the continue resumes any
  subset of queries with warm state, reranks locally and runs the hedged
  merge.  Both halves run the same per-query ops as the monolithic step, so
  the split never changes a result.

Per-shard budget laws: with ``per_shard_laws=True`` the builders take
``(n_shards,)`` float32 ``lam`` and int32 ``l_min`` tensors as runtime
inputs, and each shard's budget law uses its own pair (a 0-dim tensor of the
shard).  ``l_max`` stays global: it is the beam's width.

Each step callable takes a keyword ``active_count`` (one int32 on the
mesh's device).  Every shard's walks add their lanes that could still move
to a counter of that shard's own on its card; the counters are summed on
the mesh's device into ``active_count`` and nothing waits for a card, so
the caller reads it once (:func:`repro_torch.core.search
.check_converged`).  Without it the step reads the sum once itself, after
the last shard is queued.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from repro_torch.core import build as build_mod
from repro_torch.core import search as search_mod
from repro_torch.core.mapping import constant_alpha
from repro_torch.distributed.mesh import ShardedRows, ShardStack, place_rows
from repro_torch.pq import PqCodebook, build_lut, pq_encode, train_pq

# ``train_pq``'s default sample: the codebook is trained on this many rows
# drawn on the mesh's first device, as ``train_pq`` draws them there.
PQ_TRAIN_SAMPLE = 65536


@dataclasses.dataclass(frozen=True)
class ShardedIndexSpecs:
    """Shapes and dtypes of a sharded tiered index, as ``meta`` tensors.

    ``shard_lam`` / ``shard_l_min`` are present when the index carries
    per-shard budget laws (``per_shard_laws=True``): one (lam, l_min) pair
    per shard.
    """

    adj: torch.Tensor
    codes: torch.Tensor
    vectors: torch.Tensor
    centroids: torch.Tensor
    queries: torch.Tensor
    shard_ok: torch.Tensor
    entries: torch.Tensor
    shard_lam: torch.Tensor | None = None
    shard_l_min: torch.Tensor | None = None


def _shard_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)   # points shard over every axis


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def sharded_index_specs(mesh, *, n: int, d: int, degree: int,
                        m_pq: int | None, n_queries: int,
                        data_dtype=torch.float32,
                        per_shard_laws: bool = False) -> ShardedIndexSpecs:
    """The index's shapes and dtypes for ``mesh``: ``n`` padded up to a
    multiple of the shard count, ``max(m_pq, 1)`` code bytes."""
    n_shards = mesh.n_shards
    n_pad = ((n + n_shards - 1) // n_shards) * n_shards
    m = max(m_pq or 0, 1)
    laws = {}
    if per_shard_laws:
        laws = dict(shard_lam=_meta((n_shards,), torch.float32),
                    shard_l_min=_meta((n_shards,), torch.int32))
    return ShardedIndexSpecs(
        adj=_meta((n_pad, degree), torch.int32),
        codes=_meta((n_pad, m), torch.uint8),
        vectors=_meta((n_pad, d), data_dtype),
        centroids=_meta((m, 256, max(d // m, 1)), torch.float32),
        queries=_meta((n_queries, d), torch.float32),
        shard_ok=_meta((n_shards,), torch.bool),
        entries=_meta((n_shards,), torch.int32),
        **laws)


def _shard_eval(codes, vectors, use_pq: bool) -> search_mod.DistEval:
    """The shard-local distance evaluator (PQ/ADC or exact), whose table the
    walk kernel reads."""
    return search_mod._pq_eval(codes) if use_pq else search_mod._exact_eval(
        vectors)


def _shard_ctxs(centroids, queries, use_pq: bool) -> torch.Tensor:
    """Per-query walk contexts: ADC LUTs (PQ) or the raw queries (exact)."""
    if use_pq:
        return build_lut(queries.to(torch.float32), centroids)
    return queries


def _local_rerank(beam_ids, vectors, queries, k: int):
    """Local exact rerank from the shard's own full-precision rows: INVALID
    at +inf, then a stable ascending sort.  Returns (d2, local_ids), each
    (Q, k)."""
    ids, d2 = search_mod._rerank_slow_tier(beam_ids, vectors.to(torch.float32),
                                           queries.to(torch.float32), k)
    return d2, ids


def _hedged_merge(d2, ids, ok, mesh, axes, merge: str):
    """Global top-k merge of the per-shard (S, Q, k) candidates ``d2`` /
    ``ids``, hedged by the (S,) ``shard_ok`` mask ``ok`` (a late or dead
    shard contributes +inf).  Returns (d2, shard_id, local_id), each (Q, k).

    merge:
      * "flat": one gather of (S, Q, k), flattened shard-major to (Q, S*k),
        then one stable sort;
      * "hierarchical": one mesh axis at a time, innermost first, each a
        stable top-k over that axis's members, carrying the ``local`` id
        plane and one ``pos_<axis>`` plane per reduced axis.
    The two may order ties differently; each is the reference's own mode.
    """
    d2 = torch.where(ok[:, None, None], d2, torch.inf)
    s, q, k = d2.shape
    dev = d2.device
    if merge == "flat":
        flat_d2 = d2.transpose(0, 1).reshape(q, s * k)
        flat_ids = ids.transpose(0, 1).reshape(q, s * k)
        flat_sid = torch.arange(s, dtype=torch.int32, device=dev).view(
            1, s, 1).expand(q, s, k).reshape(q, s * k)
        order = torch.argsort(flat_d2, dim=1, stable=True)[:, :k]
        return (torch.gather(flat_d2, 1, order),
                torch.gather(flat_sid, 1, order),
                torch.gather(flat_ids, 1, order))
    if merge != "hierarchical":
        raise ValueError(f"unknown merge {merge!r}")
    dims = tuple(mesh.shape[a] for a in axes)
    d2 = d2.reshape(dims + (q, k))
    planes = {"local": ids.reshape(dims + (q, k))}

    def flatten(t, n_a):          # (..., n_a, Q, k) -> (..., Q, n_a * k)
        return t.movedim(-3, -2).reshape(t.shape[:-3] + (q, n_a * k))

    # Reduce the last remaining mesh axis each time (the innermost first).
    for a in reversed(axes):
        n_a = mesh.shape[a]
        flat_d2 = flatten(d2, n_a)
        order = torch.argsort(flat_d2, dim=-1, stable=True)[..., :k]
        d2 = torch.gather(flat_d2, -1, order)
        planes = {name: torch.gather(flatten(pl, n_a), -1, order)
                  for name, pl in planes.items()}
        src = torch.arange(n_a, dtype=torch.int32, device=dev).view(
            1, n_a, 1).expand(q, n_a, k).reshape(q, n_a * k)
        planes[f"pos_{a}"] = torch.gather(
            src.expand(flat_d2.shape), -1, order)
    sid = torch.zeros_like(planes["local"])
    stride = 1
    for a in reversed(axes):
        sid = sid + planes[f"pos_{a}"] * stride
        stride *= mesh.shape[a]
    return d2, sid, planes["local"]


def _chunks(nq: int, chunk: int) -> list[slice]:
    """Query slices of ``chunk`` lanes; a zero-query batch is one empty
    chunk (the outputs keep their shapes)."""
    return [slice(a, a + chunk) for a in range(0, nq, chunk)] or [slice(0, 0)]


def _shard_rows(mesh, t, s: int, per: int) -> torch.Tensor:
    """Shard ``s``'s rows for its stream: its block of a
    :class:`ShardedRows`, or its rows of a shard-major tensor on its
    device (inside ``mesh.on_shard(s)``)."""
    if isinstance(t, ShardedRows):
        return t.parts[s]
    if t.device != mesh.shard_devices[s]:
        raise ValueError(f"shard-major rows on {t.device} for shard {s} on "
                         f"{mesh.shard_devices[s]}: place the index on the "
                         f"mesh first (place_arrays)")
    return mesh.to_shard(t[s * per:(s + 1) * per], s)


def _shard_item(mesh, t, s: int) -> torch.Tensor:
    """Shard ``s``'s 0-dim entry of an ``(n_shards,)`` vector (entries, a
    per-shard law), on its device."""
    if isinstance(t, ShardedRows):
        return t.parts[s][0]
    return mesh.to_shard(torch.as_tensor(t)[s], s)


def _shard_leaf(mesh, a, s: int) -> torch.Tensor:
    """Shard ``s``'s ``(Q, ...)`` block of a ``(Q, n_shards, ...)`` state
    leaf, on its device."""
    if isinstance(a, ShardStack):
        return a.parts[s]
    return mesh.to_shard(a[:, s].contiguous(), s)


def _law(mesh, laws, s: int, per_shard_laws: bool):
    """Shard ``s``'s (lam, l_min) 0-dim tensors, or (None, None)."""
    if not per_shard_laws:
        return None, None
    if len(laws) != 2:
        raise ValueError("per_shard_laws steps take (shard_lam, shard_l_min)")
    return _shard_item(mesh, laws[0], s), _shard_item(mesh, laws[1], s)


def _settle_counts(counts, active_count) -> None:
    """Sum the shards' counters (already on the mesh's device) into
    ``active_count``, or read the sum once when there is none."""
    total = torch.stack(counts).sum(0, dtype=torch.int32)
    if active_count is None:
        search_mod.check_converged(total)
    else:
        active_count += total


def _local_search(adj, codes, vectors, ctxs, queries, entry, *,
                  beam_width: int, max_hops: int, k: int, query_chunk: int,
                  use_pq: bool,
                  beam_budget: search_mod.AdaptiveBeamBudget | None = None,
                  bucket_ceilings: tuple[int, ...] | None = None,
                  lam=None, l_min=None, active_count=None):
    """Per-shard search over the local sub-graph, in ``query_chunk`` groups,
    on the current stream of the shard's device.  Returns (d2, local_ids),
    each (Q, k).

    ``ctxs`` are the batch's walk contexts (ADC LUTs or the queries) and
    ``entry`` the shard's own entry point (its local medoid).  With
    ``beam_budget`` the shard runs the adaptive engine, its budgets
    computed on this shard from its own probe beam; ``lam`` / ``l_min``
    override the law with this shard's values.  ``bucket_ceilings``
    quantizes each budget up to its ceiling and derives the hop limit from
    it (a discrete family of per-shard hop deadlines, capped by
    ``max_hops``).
    """
    nq = queries.shape[0]
    n_local = adj.shape[0]
    eval_dists = _shard_eval(codes, vectors, use_pq)
    d2s, idss = [], []
    for sl in _chunks(nq, query_chunk):
        if beam_budget is not None:
            # max_hops still caps every per-query hop limit.
            beam_ids, _, _, _ = search_mod.adaptive_search_batch(
                ctxs[sl], adj, entry, eval_dists, n_local, beam_budget,
                max_hops=max_hops, bucket_ceilings=bucket_ceilings, lam=lam,
                l_min=l_min, active_count=active_count)
        else:
            beam_ids, _, _ = search_mod.fixed_search_batch(
                ctxs[sl], adj, entry, eval_dists, n_local, beam_width,
                max_hops, active_count=active_count)
        d2, ids = _local_rerank(beam_ids, vectors, queries[sl], k)
        d2s.append(d2)
        idss.append(ids)
    return torch.cat(d2s), torch.cat(idss)


def _bucket_ceilings(budget_cfg, budget_buckets):
    if budget_cfg is not None and budget_buckets and budget_buckets > 1:
        return search_mod.budget_bucket_ceilings(
            budget_cfg.l_min, budget_cfg.l_max, budget_buckets)
    return None


def make_distributed_search(mesh, *, beam_width: int, max_hops: int, k: int,
                            query_chunk: int = 128, use_pq: bool = True,
                            merge: str = "hierarchical",
                            beam_budget: search_mod.AdaptiveBeamBudget
                            | None = None,
                            budget_buckets: int | None = None,
                            per_shard_laws: bool = False):
    """The *monolithic* sharded search step for ``mesh``.

    step(adj, codes, vectors, centroids, queries, shard_ok, entries
         [, shard_lam, shard_l_min], *, active_count=None)
      -> (d2 (Q, k), shard_id (Q, k), local_id (Q, k))

    ``entries`` holds the per-shard entry points.  Global ids come back as
    (shard, local_id) pairs, on the mesh's device.  ``beam_budget`` None
    walks every query at ``beam_width``; an
    :class:`~repro_torch.core.search.AdaptiveBeamBudget` switches every
    shard to the adaptive engine.  ``budget_buckets`` quantizes each shard's
    budgets up to at most that many halving ceilings and derives each
    query's hop limit from its ceiling.  ``per_shard_laws``: the step takes
    (n_shards,) float32 ``shard_lam`` and int32 ``shard_l_min``.
    """
    axes = _shard_axes(mesh)
    bucket_ceilings = _bucket_ceilings(beam_budget, budget_buckets)

    def step(adj, codes, vectors, centroids, queries, shard_ok, entries,
             *laws, active_count=None):
        per = adj.shape[0] // mesh.n_shards
        queries = queries.to(torch.float32)
        nq = queries.shape[0]
        if nq % query_chunk:
            raise ValueError(f"batch of {nq} queries is not divisible by "
                             f"query_chunk={query_chunk}")
        ctxs = _shard_ctxs(centroids, queries, use_pq)
        caller = mesh.caller()
        d2s, idss, counts = [], [], []
        for s in range(mesh.n_shards):
            with mesh.on_shard(s, after=caller):
                lam, l_min = _law(mesh, laws, s, per_shard_laws)
                left = torch.zeros((1,), dtype=torch.int32,
                                   device=mesh.shard_devices[s])
                d2, ids = _local_search(
                    _shard_rows(mesh, adj, s, per),
                    _shard_rows(mesh, codes, s, per),
                    _shard_rows(mesh, vectors, s, per),
                    mesh.to_shard(ctxs, s), mesh.to_shard(queries, s),
                    _shard_item(mesh, entries, s),
                    beam_width=beam_width, max_hops=max_hops, k=k,
                    query_chunk=query_chunk, use_pq=use_pq,
                    beam_budget=beam_budget, bucket_ceilings=bucket_ceilings,
                    lam=lam, l_min=l_min, active_count=left)
                d2s.append(mesh.to_caller(d2, caller))
                idss.append(mesh.to_caller(ids, caller))
                counts.append(mesh.to_caller(left, caller))
        mesh.join(caller)
        _settle_counts(counts, active_count)
        return _hedged_merge(torch.stack(d2s), torch.stack(idss),
                             shard_ok.to(mesh.device), mesh, axes, merge)

    return step


def make_distributed_probe(mesh, *,
                           budget_cfg: search_mod.AdaptiveBeamBudget,
                           max_hops: int, query_chunk: int = 128,
                           use_pq: bool = True,
                           budget_buckets: int | None = None,
                           per_shard_laws: bool = False):
    """The probe half of the staged distributed step.

    probe(adj, codes, vectors, centroids, queries, entries
          [, shard_lam, shard_l_min], *, active_count=None)
      -> (probe_state, budgets, hop_limits, q_lid)

    Every shard walks every query ``probe_hops`` hops at its budget floor,
    estimates each query's LID from its local probe beam and grants
    per-shard budgets and hop limits (quantized up to the bucket ceilings
    when ``budget_buckets`` is set, as the monolithic step does).
    ``probe_state`` is (beam_ids, beam_d, beam_exp, visited, hops, evals,
    ctx): the per-shard leaves are :class:`ShardStack` s laid out
    ``(Q, n_shards, ...)``, each shard's block on its card (the visited
    words int32 carrying uint32 bit patterns), and ``ctx`` (the ADC LUTs or
    the queries) is shared by every shard, on the mesh's device;
    ``budgets`` / ``hop_limits`` / ``q_lid`` are (Q, n_shards) there.

    Queries are probed in ``query_chunk`` groups, as the monolithic step
    does (so a batch-mean LID centre sees the same chunks); a batch not
    divisible by the chunk runs as one chunk, up to
    ``max(4 * query_chunk, 512)`` lanes; past that it raises ``ValueError``.
    """
    bucket_ceilings = _bucket_ceilings(budget_cfg, budget_buckets)

    def step(adj, codes, vectors, centroids, queries, entries, *laws,
             active_count=None):
        per = adj.shape[0] // mesh.n_shards
        queries = queries.to(torch.float32)
        nq = queries.shape[0]
        chunk = query_chunk if nq % query_chunk == 0 else nq
        # Ragged micro-batches run as one chunk (their visited words are
        # few); a bulk batch must land on the chunk grid.
        if chunk > max(4 * query_chunk, 512):
            raise ValueError(
                f"batch of {nq} queries is not divisible by "
                f"query_chunk={query_chunk} and too large to probe as one "
                f"chunk; align bulk batches to the chunk grid")
        ctxs = _shard_ctxs(centroids, queries, use_pq)
        caller = mesh.caller()
        walks, grants, counts = [], [], []
        for s in range(mesh.n_shards):
            with mesh.on_shard(s, after=caller):
                lam, l_min = _law(mesh, laws, s, per_shard_laws)
                adj_s = _shard_rows(mesh, adj, s, per)
                eval_dists = _shard_eval(_shard_rows(mesh, codes, s, per),
                                         _shard_rows(mesh, vectors, s, per),
                                         use_pq)
                ctxs_s = mesh.to_shard(ctxs, s)
                entry = _shard_item(mesh, entries, s)
                left = torch.zeros((1,), dtype=torch.int32,
                                   device=mesh.shard_devices[s])
                outs = []
                for sl in _chunks(nq, chunk):
                    st, budgets, hop_limits, q_lid = (
                        search_mod.adaptive_probe_batch(
                            ctxs_s[sl], adj_s, entry, eval_dists, per,
                            budget_cfg, max_hops=max_hops, lam=lam,
                            l_min=l_min, active_count=left))
                    if bucket_ceilings is not None:
                        _, budgets = search_mod.quantize_budgets(
                            budgets, bucket_ceilings)
                        hop_limits = search_mod._bucket_hop_limits(
                            budget_cfg, budgets, max_hops)
                    outs.append(tuple(st) + (budgets, hop_limits, q_lid))
                leaves = [torch.cat(parts) for parts in zip(*outs)]
                walks.append(leaves[:6])
                grants.append([mesh.to_caller(t, caller)
                               for t in leaves[6:]])
                counts.append(mesh.to_caller(left, caller))
        mesh.join(caller)
        _settle_counts(counts, active_count)
        state = tuple(ShardStack(mesh, parts) for parts in zip(*walks))
        budgets, hop_limits, q_lid = [torch.stack(parts, 1)
                                      for parts in zip(*grants)]
        return state + (ctxs,), budgets, hop_limits, q_lid

    return step


def make_distributed_continue(mesh, *,
                              budget_cfg: search_mod.AdaptiveBeamBudget,
                              k: int, use_pq: bool = True,
                              merge: str = "hierarchical"):
    """The continue half of the staged distributed step.

    cont(adj, codes, vectors, centroids, probe_state, queries, budgets,
         hop_limits, shard_ok, *, active_count=None)
      -> (d2 (q, k), shard_id (q, k), local_id (q, k),
          hops (q,), dist_evals (q,))

    Resumes the checkpointed shard walks (warm beam and visited set), each
    on its shard's stream and card, for any query subset of a probe's batch
    (the host selects rows on axis 0 of every probe output), reranks
    locally and runs the same hedged merge as the monolithic step.
    ``shard_ok`` is consumed here, at merge time.  ``hops`` /
    ``dist_evals`` are per-query totals over the live shards.
    """
    axes = _shard_axes(mesh)

    def step(adj, codes, vectors, centroids, state, queries, budgets,
             hop_limits, shard_ok, active_count=None):
        per = adj.shape[0] // mesh.n_shards
        queries = queries.to(torch.float32)
        *walk, ctx = state
        caller = mesh.caller()
        d2s, idss, hops, evals, counts = [], [], [], [], []
        for s in range(mesh.n_shards):
            with mesh.on_shard(s, after=caller):
                walk_s = tuple(_shard_leaf(mesh, a, s) for a in walk)
                vectors_s = _shard_rows(mesh, vectors, s, per)
                left = torch.zeros((1,), dtype=torch.int32,
                                   device=mesh.shard_devices[s])
                beam_ids, _, h, e = search_mod.adaptive_continue_batch(
                    walk_s, mesh.to_shard(ctx, s),
                    _shard_rows(mesh, adj, s, per),
                    _shard_eval(_shard_rows(mesh, codes, s, per), vectors_s,
                                use_pq),
                    budget_cfg, _shard_leaf(mesh, budgets, s),
                    _shard_leaf(mesh, hop_limits, s), active_count=left)
                d2, ids = _local_rerank(beam_ids, vectors_s,
                                        mesh.to_shard(queries, s), k)
                for out, t in ((d2s, d2), (idss, ids), (hops, h),
                               (evals, e), (counts, left)):
                    out.append(mesh.to_caller(t, caller))
        mesh.join(caller)
        _settle_counts(counts, active_count)
        d2, sid, lid = _hedged_merge(torch.stack(d2s), torch.stack(idss),
                                     shard_ok.to(mesh.device), mesh, axes,
                                     merge)
        live = shard_ok.to(mesh.device)[:, None]
        live_hops = torch.where(live, torch.stack(hops), 0).sum(
            0, dtype=torch.int32)
        live_evals = torch.where(live, torch.stack(evals), 0).sum(
            0, dtype=torch.int32)
        return d2, sid, lid, live_hops, live_evals

    return step


def _on_device(dev: torch.device):
    """``dev`` made the current card (nothing off the card)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def shard_medoids(vectors, n_shards: int):
    """Per-shard entry points: the local medoid of each shard's rows.

    For shard-major ``vectors`` an (n_shards,) int32 tensor; for
    :class:`ShardedRows` one ``(1,)`` block a shard, each computed on the
    shard's own device (the host waits for them)."""
    if isinstance(vectors, ShardedRows):
        parts = []
        for p in vectors.parts:
            with _on_device(p.device):
                parts.append(search_mod.medoid(p).reshape(1))
        for d in dict.fromkeys(p.device for p in parts):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return ShardedRows(parts)
    per = vectors.shape[0] // n_shards
    blocks = vectors[:per * n_shards].reshape(n_shards, per, -1)
    return torch.stack([search_mod.medoid(b) for b in blocks])


def place_arrays(mesh, arrays: dict) -> dict:
    """A distributed index dict placed on ``mesh``: ``adj`` / ``codes`` /
    ``vectors`` / ``entries`` as :class:`ShardedRows` (each shard's rows on
    its own device; the entries computed there when absent), ``centroids``
    on the mesh's first device, where each batch's LUTs are built before
    they are copied to every card.  The host waits for the copies."""
    out = {name: place_rows(mesh, arrays[name])
           for name in ("adj", "codes", "vectors")}
    out["centroids"] = torch.as_tensor(arrays["centroids"],
                                       device=mesh.device)
    out["entries"] = (place_rows(mesh, arrays["entries"],
                                 dtype=torch.int32)
                      if "entries" in arrays
                      else shard_medoids(out["vectors"], mesh.n_shards))
    mesh.synchronize()
    return out


def _assemble(mesh, parts):
    """Per-shard blocks as the index holds them on ``mesh``: one
    shard-major tensor on a one-device mesh, else :class:`ShardedRows`."""
    return ShardedRows(parts) if mesh.spread else torch.cat(parts)


def _pq_sample(x: torch.Tensor, dev: torch.device, seed: int) -> torch.Tensor:
    """The codebook's training rows on ``dev``: the sample ``train_pq``
    draws there (``PQ_TRAIN_SAMPLE`` rows by a seeded permutation), read
    from ``x`` wherever it lies."""
    n = x.shape[0]
    if n <= PQ_TRAIN_SAMPLE:
        return x.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pick = torch.randperm(n, generator=gen, device=dev)[:PQ_TRAIN_SAMPLE]
    return x[pick.to(x.device)].to(dev)


def build_sharded_arrays(x, mesh, *, build_cfg: build_mod.BuildConfig,
                         m_pq: int = 8, alpha: float = 1.2,
                         pq_iters: int = 4, seed: int = 0,
                         timings: dict | None = None) -> tuple[dict, int]:
    """Build a distributed index for ``mesh``, each shard on its device.

    One locally built sub-graph per shard (shard-local ids, static
    ``alpha``), built on the shard's own device from its rows, which stay
    there: no shard's rows pass through another card (``x`` may lie on the
    host).  The PQ codebook is trained once, on the mesh's first device,
    and each shard's codes are encoded on its device with a copy of it; the
    entry medoids are computed per shard.  ``x`` is truncated to a multiple
    of the shard count.  ``timings`` (a dict) gains each shard's build
    seconds (``shard_<s>``) and the PQ tier's (``pq``), the cards
    synchronised.  Returns (arrays dict, rows_per_shard): shard-major
    tensors on a one-device mesh, :class:`ShardedRows` on a mesh of
    several devices.
    """
    n_shards = mesh.n_shards
    x = torch.as_tensor(x, dtype=torch.float32)
    n = (x.shape[0] // n_shards) * n_shards
    x = x[:n]
    per = n // n_shards
    rows, adjs = [], []
    for s in range(n_shards):
        dev = mesh.shard_devices[s]
        with _on_device(dev):
            x_s = x[s * per:(s + 1) * per].to(dev)
            with build_mod._phase_clock(timings, dev)(f"shard_{s}"):
                adjs.append(build_mod.build_with_alpha(
                    x_s, constant_alpha(per, alpha, dev), build_cfg))
        rows.append(x_s)
    mesh.synchronize()
    t0 = time.perf_counter()
    book = train_pq(_pq_sample(x, mesh.device, seed), m=m_pq, iters=pq_iters,
                    seed=seed, sample=None)
    codes = []
    for x_s in rows:
        with _on_device(x_s.device):
            codes.append(pq_encode(x_s, PqCodebook(
                book.centroids.to(x_s.device))))
    mesh.synchronize()
    if timings is not None:
        timings["pq"] = timings.get("pq", 0.0) + time.perf_counter() - t0
    one = not mesh.spread and x.device == mesh.device
    arrays = {"adj": _assemble(mesh, adjs),
              "codes": _assemble(mesh, codes),
              "vectors": x if one else _assemble(mesh, rows),
              "centroids": book.centroids}
    entries = shard_medoids(ShardedRows(rows), n_shards)
    arrays["entries"] = (entries if mesh.spread
                         else torch.cat(entries.parts))
    return arrays, per


def distributed_search(mesh, index_arrays: dict, queries, shard_ok=None,
                       shard_laws=None, **kw):
    """Eager entry (tests, examples): ``index_arrays`` holds adj / codes /
    vectors / centroids (optionally entries), shard-major on a one-device
    mesh's device or placed on the mesh (:func:`place_arrays`).  Without
    ``entries`` the per-shard medoids are recomputed on every call.
    ``shard_laws`` is an optional (lam (S,), l_min (S,)) pair.
    """
    step = make_distributed_search(
        mesh, per_shard_laws=shard_laws is not None, **kw)
    dev = mesh.device
    if shard_ok is None:
        shard_ok = torch.ones((mesh.n_shards,), dtype=torch.bool, device=dev)
    shard_ok = torch.as_tensor(shard_ok, dtype=torch.bool, device=dev)
    entries = index_arrays.get("entries")
    if entries is None:
        entries = shard_medoids(index_arrays["vectors"], mesh.n_shards)
    laws = ()
    if shard_laws is not None:
        laws = (torch.as_tensor(shard_laws[0], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(shard_laws[1], dtype=torch.int32,
                                device=dev))
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    return step(index_arrays["adj"], index_arrays["codes"],
                index_arrays["vectors"],
                torch.as_tensor(index_arrays["centroids"], device=dev),
                queries, shard_ok, entries, *laws)
