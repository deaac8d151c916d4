"""The serving engine: one API over the exact, tiered, out-of-core and
distributed backends, with a staged double-buffered batch pipeline (port of
:mod:`repro.serving.engine`).

* :class:`SearchEngine` wraps a backend behind ``search`` (one batch) and
  ``search_batches`` (a stream, double-buffered).
* Staged backends (:class:`ExactBackend`, :class:`TieredBackend`) expose the
  adaptive engine's probe / continue / rerank separately, so the host's
  bucket scheduling sits between device work of different batches.  Results
  are identical to the unpipelined path: the same programs on the same
  inputs, only the order of dispatch moves.
* Fixed-beam serving runs one walk per batch.
* Distributed: :class:`DistributedBackend` serves a sharded index through
  :mod:`repro_torch.distributed.sharded_search`, staged (probe / hedged
  continue) when adaptive, one monolithic step (``dispatch`` / ``collect``)
  otherwise.
* Disk slow tier: a :class:`TieredBackend` over a
  :class:`repro_torch.index.disk.BlockSlowTier` serves the rerank's fetch
  from the block store on the host, and the pipeline grows a third stage,
  *prefetch*, between continue and gather: batch i's block reads run on the
  tier's worker thread while batch i+1's walk runs on the card.  Each gather
  then kicks one non-blocking promotion tick of the tier's hot tier, and
  the tier's counters ride in ``BatchResult.extras["slow_tier"]``.
* Out-of-core: :class:`OutOfCoreBackend` keeps only the PQ codes on the
  card and reads the adjacency too from the block store, a hop at a time
  (:func:`repro_torch.index.disk.ooc_walk`); the pipeline grows a
  *walk-prefetch* stage ahead of the continue, which submits the reads of
  the continue's first frontier to the tier's workers (cache warm-up only).

On the card every stage runs on the engine's own CUDA stream, and each
flight records an event after its device work; the gather waits on it
before the host copies.  The dispatch stage (the pipeline's first, and
the front door's ``begin``) waits for nothing on the device: the queries
go up through pinned memory without blocking, every constant of the
probe and grant is filled on the card, and the walk's convergence
counter is read where the flight is first read on the host (the schedule
stage, a partial result, or a fixed-beam or monolithic flight's
collection), which raises as :func:`repro_torch.core.search.run_batch`
does.  On the CPU the stages run
synchronously and give the same arrays.

``coalesce_lanes=`` merges micro-batches below the threshold into one
dispatch and splits the results back; filters (an allowed mask per query)
are enforced in-graph; ``begin`` / ``finish_from`` / ``partial_result`` are
the front door's dispatch seam and deadline gather.  A partial result waits
only for its flight's probe (an event recorded right after it) and copies
and reranks on a stream of its own, so it never queues behind the continue
walk on the engine's stream; the continue clones the probe state, so that
state is never written after ``begin``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import calibrate as calib
from repro_torch.core import search as search_mod
from repro_torch.distributed import sharded_search as ss
from repro_torch.distributed.mesh import place_rows
from repro_torch.index import disk as disk_mod
from repro_torch.pq import PqCodebook
from repro_torch.serving import pipeline as pipe


@dataclasses.dataclass
class BatchResult:
    """One batch's results, host-side (numpy), original query order."""

    ids: np.ndarray                       # (Q, k)
    d2: np.ndarray                        # (Q, k)
    stats: search_mod.SearchStats | None = None
    astats: search_mod.AdaptiveStats | None = None
    ceilings: tuple[int, ...] | None = None   # bucket family actually used
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" names the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device`` without a host
    sync: on the card through pinned memory, copied on the current stream
    without blocking (a pageable copy would wait for the stream); on the
    CPU the array's own memory."""
    t = torch.as_tensor(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _host_stats(stats):
    if stats is None:
        return None
    return search_mod.SearchStats(hops=stats.hops.cpu().numpy(),
                                  dist_evals=stats.dist_evals.cpu().numpy())


def _split_result(res: BatchResult, sizes: list[int]) -> list[BatchResult]:
    """Split a coalesced dispatch's result back into per-input-batch
    results (per-query arrays sliced on axis 0, the rest shared)."""
    outs, off = [], 0
    for s in sizes:
        sl = slice(off, off + s)
        off += s
        stats = None if res.stats is None else search_mod.SearchStats(
            hops=res.stats.hops[sl], dist_evals=res.stats.dist_evals[sl])
        astats = None if res.astats is None else search_mod.AdaptiveStats(
            q_lid=res.astats.q_lid[sl], budget=res.astats.budget[sl])
        outs.append(BatchResult(
            ids=res.ids[sl], d2=res.d2[sl], stats=stats, astats=astats,
            ceilings=res.ceilings,
            extras={k: v[sl] if isinstance(v, np.ndarray) else v
                    for k, v in res.extras.items()}))
    return outs


class _StagedRerankMixin:
    """Shared staged-protocol tail of the single-host backends.  The
    defaults are those of a backend without a disk tier: no prefetch stage,
    no promotion tick, nothing to close."""

    prefetches = False
    staged = True

    def promotion_tick(self):
        return None

    def close(self) -> None:
        pass

    def schedule_budgets(self, budgets_np: np.ndarray) -> np.ndarray:
        return budgets_np

    def partial_parts(self, probe_state) -> tuple:
        """The probe-horizon view of the walk: (beam_ids, beam_d, hops,
        evals), the part layout :meth:`finish` reranks."""
        beam_ids, beam_d, _exp, _visited, hops, evals = probe_state
        return beam_ids, beam_d, hops, evals

    def finish_extras(self) -> dict[str, Any]:
        """Per-batch observability payload (backends override)."""
        return {}

    def finish(self, queries, parts, k: int, *, q_lid, budgets_np,
               prefetch=None) -> BatchResult:
        """Rerank the gathered continue ``parts`` into the final top-k;
        ``prefetch`` is the disk tier's fetch future when the pipeline's
        prefetch stage ran."""
        beam_ids, beam_d, hops, evals = parts
        ids, d2 = self.rerank(torch.as_tensor(beam_ids, device=self.device),
                              torch.as_tensor(beam_d, device=self.device),
                              queries, k, prefetch=prefetch)
        return BatchResult(
            ids=ids.cpu().numpy(), d2=d2.cpu().numpy(),
            stats=search_mod.SearchStats(hops=np.asarray(hops),
                                         dist_evals=np.asarray(evals)),
            astats=search_mod.AdaptiveStats(
                q_lid=torch.as_tensor(q_lid).cpu().numpy(),
                budget=budgets_np),
            extras=self.finish_extras())


class ExactBackend(_StagedRerankMixin):
    """Full-precision in-memory backend: exact distances steer the walk and
    the final result is the beam's top-k slice."""

    def __init__(self, x, adj, entry, *, device="cuda"):
        self.device = resolve_device(device)
        self.update(x, adj, entry)

    def update(self, x, adj, entry) -> None:
        """Swap the index arrays in place (index refresh path)."""
        self.x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self.adj = torch.as_tensor(adj, dtype=torch.int32, device=self.device)
        self.entry = torch.as_tensor(entry, dtype=torch.int32,
                                     device=self.device)

    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    def admit(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32,
                               device=self.device)

    def probe(self, ctxs, budget_cfg, excl=None, active_count=None):
        return search_mod._probe_exact(self.x, self.adj, ctxs, self.entry,
                                       budget_cfg, excl, active_count)

    def continue_fn(self, budget_cfg):
        def cont(st, c, b, h):
            return search_mod._continue_exact(self.x, self.adj, st, c, b, h,
                                              budget_cfg)
        return cont

    def rerank(self, beam_ids, beam_d, queries, k: int, prefetch=None):
        return beam_ids[:, :k], beam_d[:, :k]

    def recall_eval(self, queries, gt_ids, *, k, sample, seed, base_cfg):
        return calib.exact_recall_eval(
            self.x, self.adj, self.entry, queries, gt_ids, k=k,
            sample=sample, seed=seed, base_cfg=base_cfg)

    def fixed(self, queries, *, beam_width: int, max_hops: int, k: int,
              excl=None, active_count=None):
        ids, d2, stats = search_mod.beam_search_exact(
            self.x, self.adj, queries, self.entry, beam_width=beam_width,
            max_hops=max_hops, k=k, excl=excl, active_count=active_count)
        return ids, d2, stats, None


class TieredBackend(_StagedRerankMixin):
    """The deployed two-tier path: PQ codes route the walk (fast tier) and
    the final beam is reranked from full-precision rows (slow tier).
    ``rerank=False`` serves raw ADC results.

    ``slow_tier`` plugs the rerank's fetch: ``None`` keeps the device rows
    of ``index.vectors``; a :class:`repro_torch.index.disk.BlockSlowTier`
    serves them from the block store on the host instead (the rerank's
    arithmetic stays the same, so results are bit-identical), and sets
    :attr:`prefetches`, which adds the engine's prefetch stage."""

    _UNSET = object()

    def __init__(self, index: disk_mod.TieredIndex, rerank: bool = True,
                 slow_tier=None, *, device="cuda"):
        self.device = resolve_device(device)
        self.do_rerank = rerank
        self.slow_tier = None
        self.update(index, slow_tier=slow_tier)

    def update(self, index: disk_mod.TieredIndex, slow_tier=_UNSET) -> None:
        """Swap the tiered index (and the slow tier) in place.  A
        disk-backed backend refuses a refresh that does not name its slow
        tier (the old store holds the old vectors); a replaced disk tier is
        closed."""
        if not _same_device(index.device, self.device):
            raise ValueError(f"index lives on {index.device}, backend on "
                             f"{self.device}")
        if slow_tier is TieredBackend._UNSET:
            if self._disk:
                raise ValueError(
                    "this backend serves its slow tier from a block store; "
                    "refresh with update(index, slow_tier=...) — a "
                    "BlockSlowTier over a store written from the new "
                    "vectors, or None to return to in-memory rows")
            slow_tier = None
        old = self.slow_tier
        self.index = index
        self.slow_tier = slow_tier
        if old is not None and old is not slow_tier and old.is_disk:
            old.close()

    @property
    def _disk(self) -> bool:
        return self.slow_tier is not None and self.slow_tier.is_disk

    def close(self) -> None:
        """Shut down a disk slow tier's threads (idempotent)."""
        if self._disk:
            self.slow_tier.close()

    @property
    def prefetches(self) -> bool:
        """Whether the rerank's fetch is worth hiding behind device work."""
        return self.do_rerank and self._disk

    def num_nodes(self) -> int:
        return int(self.index.codes.shape[0])

    def admit(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return disk_mod._query_luts(self.index, q)

    def probe(self, ctxs, budget_cfg, excl=None, active_count=None):
        return search_mod._probe_pq(self.index.codes, self.index.graph.adj,
                                    ctxs, self.index.graph.entry, budget_cfg,
                                    excl, active_count)

    def continue_fn(self, budget_cfg):
        def cont(st, c, b, h):
            return search_mod._continue_pq(self.index.codes,
                                           self.index.graph.adj, st, c, b, h,
                                           budget_cfg)
        return cont

    def prefetch_rerank(self, parts):
        """Submit the block fetch of the gathered continue ``parts``
        (beam ids first, host numpy) to the tier's worker pool."""
        return self.slow_tier.prefetch(np.asarray(parts[0]))

    def rerank(self, beam_ids, beam_d, queries, k: int, prefetch=None):
        if not self.do_rerank:
            return beam_ids[:, :k], beam_d[:, :k]
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if self.prefetches:
            return disk_mod.rerank_with_slow_tier(
                self.slow_tier, beam_ids, q, k,
                prefetched=None if prefetch is None else prefetch.result())
        x_slow = (self.slow_tier.vectors if self.slow_tier is not None
                  else self.index.vectors)
        return search_mod._rerank_slow_tier(beam_ids, x_slow, q, k)

    def finish_extras(self) -> dict[str, Any]:
        return {"slow_tier": self.slow_tier.stats()} if self._disk else {}

    def promotion_tick(self):
        """Kick one hot-tier promotion round on the disk tier's promoter
        thread (non-blocking; None without a disk or hot tier)."""
        return self.slow_tier.promotion_tick() if self._disk else None

    def recall_eval(self, queries, gt_ids, *, k, sample, seed, base_cfg):
        return calib.tiered_recall_eval(
            self.index, queries, gt_ids, k=k, sample=sample, seed=seed,
            base_cfg=base_cfg)

    def fixed(self, queries, *, beam_width: int, max_hops: int, k: int,
              excl=None, active_count=None):
        if self.prefetches:
            # Walk un-reranked at full beam width, then rerank from the
            # block store (no later stage to hide this fetch behind).
            beam_ids, _beam_d, stats = disk_mod.search_tiered(
                self.index, queries, beam_width=beam_width,
                max_hops=max_hops, k=beam_width, rerank=False, excl=excl,
                active_count=active_count)
            ids, d2 = disk_mod.rerank_with_slow_tier(self.slow_tier,
                                                     beam_ids, queries, k)
            return ids, d2, stats, None
        ids, d2, stats = disk_mod.search_tiered(
            self.index, queries, beam_width=beam_width, max_hops=max_hops,
            k=k, rerank=self.do_rerank, excl=excl, active_count=active_count)
        return ids, d2, stats, None


class OutOfCoreBackend(_StagedRerankMixin):
    """Serve an index larger than device memory: only the PQ codes (and the
    codebook and entry) live on the card to steer the walk; the adjacency
    and the full-precision vectors stay in the block store and are read at
    walk and rerank time through the slow tier's worker threads.

    The walk runs the out-of-core drivers of :mod:`repro_torch.index.disk`
    (:func:`~repro_torch.index.disk.ooc_probe` /
    :func:`~repro_torch.index.disk.ooc_continue`): each hop is split at the
    frontier selection, so the host reads ``adj[u]`` from the store between
    two launches of the row-fed ``beam_step`` hop, with ``io_groups`` lane
    groups round-robined so one group's reads overlap another's hop.
    Results are bit-identical to the in-memory :class:`TieredBackend`.

    ``walk_prefetches`` makes the engine run a walk-prefetch stage: up to
    ``io_depth`` of the continue's first-frontier rows are submitted to the
    tier's workers one stage before the continue (cache warm-up, never a
    change of result).  ``timings`` (None, or a dict) collects the walk's
    host times (:func:`repro_torch.index.disk.ooc_walk`, which adds each
    walk's under a lock, so walks on several threads may share it).
    """

    prefetches = True        # the rerank's fetch is always a disk read here
    walk_prefetches = True

    def __init__(self, codes, codebook, entry, slow_tier, *,
                 io_groups: int = 2, io_depth: int = 32, device="cuda"):
        self.device = resolve_device(device)
        self.io_groups = io_groups
        self.io_depth = io_depth
        self.timings: dict | None = None
        self.slow_tier = None
        self.update(codes, codebook, entry, slow_tier=slow_tier)

    def update(self, codes, codebook, entry, *, slow_tier) -> None:
        """Swap the steering arrays and the block-store tier in place (the
        index refresh path).  ``slow_tier`` is a required keyword: the store
        holds the graph itself here, so a refresh that does not name it
        would serve a stale graph.  A replaced tier is closed; the tier's
        prefetch pool is sized to ``io_groups`` unless it was given a
        worker count."""
        if slow_tier is None or not getattr(slow_tier, "is_disk", False):
            raise ValueError(
                "out-of-core serving needs a BlockSlowTier over a store "
                "holding the graph's adjacency and vectors")
        old = self.slow_tier
        self.codes = torch.as_tensor(codes, dtype=torch.uint8,
                                     device=self.device)
        self.codebook = PqCodebook(torch.as_tensor(
            codebook.centroids, dtype=torch.float32, device=self.device))
        self.entry = torch.as_tensor(entry, dtype=torch.int32,
                                     device=self.device)
        self.slow_tier = slow_tier
        # One worker per group lets one group's reads overlap another's hop.
        slow_tier.default_io_workers(self.io_groups)
        if old is not None and old is not slow_tier:
            old.close()

    def close(self) -> None:
        """Shut down the slow tier's threads (idempotent)."""
        if self.slow_tier is not None:
            self.slow_tier.close()

    def admit(self, queries) -> torch.Tensor:
        """The LUTs of :meth:`TieredBackend.admit`, by the same ops."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return disk_mod.codebook_luts(self.codebook, q)

    def num_nodes(self) -> int:
        return int(self.codes.shape[0])

    def probe(self, ctxs, budget_cfg, excl=None, active_count=None):
        """The out-of-core probe reads its frontier on the host every hop,
        so it waits for the card anyway: ``active_count`` stays 0."""
        return disk_mod.ooc_probe(
            self.codes, ctxs, self.entry, self.num_nodes(), budget_cfg,
            self.slow_tier, io_groups=self.io_groups, excl=excl,
            timings=self.timings)

    def continue_fn(self, budget_cfg):
        def cont(st, c, b, h):
            return disk_mod.ooc_continue(
                self.codes, st, c, b, h, budget_cfg.l_max, self.slow_tier,
                io_groups=self.io_groups, timings=self.timings)
        return cont

    def prefetch_walk(self, probe_state, budgets, hop_limits):
        """Submit the reads of the continue's first frontier (at most
        ``io_depth`` nodes) to the tier's workers; returns the future, or
        None when every lane converged in the probe."""
        u = disk_mod.ooc_first_frontier(probe_state, budgets, hop_limits,
                                        int(probe_state[0].shape[1]))
        u = u[u >= 0][:self.io_depth]
        if u.size == 0:
            return None
        return self.slow_tier.prefetch_adj(u)

    def prefetch_rerank(self, parts):
        """See :meth:`TieredBackend.prefetch_rerank`."""
        return self.slow_tier.prefetch(np.asarray(parts[0]))

    def rerank(self, beam_ids, beam_d, queries, k: int, prefetch=None):
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return disk_mod.rerank_with_slow_tier(
            self.slow_tier, beam_ids, q, k,
            prefetched=None if prefetch is None else prefetch.result())

    def finish_extras(self) -> dict[str, Any]:
        return {"slow_tier": self.slow_tier.stats()}

    def promotion_tick(self):
        """See :meth:`TieredBackend.promotion_tick`; here promoted rows
        serve the walk's adjacency reads too."""
        return self.slow_tier.promotion_tick()

    def fixed(self, queries, *, beam_width: int, max_hops: int, k: int,
              excl=None, active_count=None):
        """The out-of-core walk reads its frontier on the host every hop, so
        it waits for the card anyway: ``active_count`` stays 0."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        ctxs = disk_mod.codebook_luts(self.codebook, q)
        states = search_mod.ooc_init_pq(self.codes, ctxs, self.entry,
                                        self.num_nodes(), beam_width,
                                        excl=excl)
        state = disk_mod.ooc_walk(self.codes, states, ctxs, beam_width,
                                  max_hops, beam_width, self.slow_tier,
                                  self.io_groups, self.timings)
        if excl is not None:
            state = search_mod._scrub_state(state, excl)
        ids, d2 = disk_mod.rerank_with_slow_tier(self.slow_tier, state[0],
                                                 q, k)
        return ids, d2, search_mod.SearchStats(hops=state[4],
                                               dist_evals=state[5]), None


class DistributedBackend:
    """Sharded scatter-gather serving over a :class:`~repro_torch.distributed
    .mesh.ShardMesh`: each shard walks its own sub-graph, with adaptive
    budgets and bucket deadlines computed per shard (see
    :mod:`repro_torch.distributed.sharded_search`).

    Two execution shapes:

    * built with ``beam_budget`` and driven by an engine holding the same
      budget config, the backend is **staged**: the probe checkpoints every
      shard's walk at the probe horizon and the continue resumes any query
      subset and ends in the hedged merge, so ``search_batches`` overlaps
      batch i+1's probe with batch i's host bucketing and continues.
      Budgets are granted per (query, shard); the host schedules on their
      per-query mean (:meth:`schedule_budgets`).
    * without an engine-level budget config the whole step is one call
      (``dispatch`` / ``collect``), the only shape that runs fixed-beam.

    ``shard_laws=(lam (S,), l_min (S,))`` threads per-shard budget laws
    through both shapes as runtime tensors, each shard's pair on its card.
    ``arrays`` is the dict of :func:`~repro_torch.distributed.sharded_search
    .build_sharded_arrays` (or
    :func:`repro_torch.index.convert.sharded_arrays_from_arrays`), shard-major
    or placed; the backend holds it placed on the mesh
    (:func:`~repro_torch.distributed.sharded_search.place_arrays`): each
    shard's rows on its own card, where its walks run on its own stream.
    There is no probe-horizon view of the walk on the host
    (``partial_parts``), so an engine over this backend serves no partial
    results, and filters are refused, as in the reference.
    """

    prefetches = False

    def __init__(self, mesh, arrays: dict, *, beam_width: int, max_hops: int,
                 k: int, query_chunk: int = 128, use_pq: bool = True,
                 beam_budget=None, budget_buckets: int | None = None,
                 shard_ok=None, shard_laws=None,
                 merge: str = "hierarchical"):
        self.mesh = mesh
        self.device = mesh.device
        n_shards = mesh.n_shards
        self.arrays = ss.place_arrays(mesh, arrays)
        self.rows_per_shard = self.arrays["vectors"].shape[0] // n_shards
        self.set_shard_ok(shard_ok if shard_ok is not None
                          else np.ones((n_shards,), bool))
        self.beam_budget = beam_budget
        self.shard_laws = None
        if shard_laws is not None:
            self.shard_laws = (
                place_rows(mesh, shard_laws[0], dtype=torch.float32),
                place_rows(mesh, shard_laws[1], dtype=torch.int32))
            mesh.synchronize()
        per_shard = self.shard_laws is not None
        # One more bucket costs one more continue over every shard (n_shards
        # walks and the merge), so the scheduler's modelled launch cost
        # scales with the shard count.
        self.launch_cost_hops = pipe.BUCKET_LAUNCH_COST_HOPS * n_shards
        self.step = ss.make_distributed_search(
            mesh, beam_width=beam_width, max_hops=max_hops, k=k,
            query_chunk=query_chunk, use_pq=use_pq, beam_budget=beam_budget,
            budget_buckets=budget_buckets, merge=merge,
            per_shard_laws=per_shard)
        self._probe_step = self._continue_step = None
        if beam_budget is not None:
            self._probe_step = ss.make_distributed_probe(
                mesh, budget_cfg=beam_budget, max_hops=max_hops,
                query_chunk=query_chunk, use_pq=use_pq,
                budget_buckets=budget_buckets, per_shard_laws=per_shard)
            self._continue_step = ss.make_distributed_continue(
                mesh, budget_cfg=beam_budget, k=k, use_pq=use_pq,
                merge=merge)

    @property
    def staged(self) -> bool:
        """Stageable iff the walk is adaptive (the probe horizon exists)."""
        return self.beam_budget is not None

    def set_shard_ok(self, shard_ok) -> None:
        """Runtime straggler / fault mask, consumed at merge time: in a
        pipelined stream it applies to every flight dispatched after the
        call (a flight keeps the backend as it was at its dispatch)."""
        self.shard_ok = torch.as_tensor(shard_ok, device=self.device).to(
            torch.bool)

    def _laws(self) -> tuple:
        return self.shard_laws if self.shard_laws is not None else ()

    def promotion_tick(self):
        return None

    def close(self) -> None:
        pass

    def finish_extras(self) -> dict[str, Any]:
        return {}

    # ------------------------------------------------- monolithic protocol

    def dispatch(self, queries, active_count=None):
        """The whole step for one batch; ``active_count`` takes every shard
        walk's counter (nothing waits for the card)."""
        a = self.arrays
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return self.step(a["adj"], a["codes"], a["vectors"], a["centroids"],
                         q, self.shard_ok, a["entries"], *self._laws(),
                         active_count=active_count)

    def collect(self, handles) -> BatchResult:
        d2, shard_ids, local_ids = handles
        sid = shard_ids.cpu().numpy().astype(np.int64)
        lid = local_ids.cpu().numpy().astype(np.int64)
        return BatchResult(ids=sid * self.rows_per_shard + lid,
                           d2=d2.cpu().numpy(),
                           extras={"shard_ids": sid, "local_ids": lid})

    # ----------------------------------------------------- staged protocol

    def admit(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32,
                               device=self.device)

    def probe(self, ctxs, budget_cfg, excl=None, active_count=None):
        if excl is not None:
            raise NotImplementedError(
                "filtered search is not supported on the distributed "
                "backend: the filter words are indexed by global node id "
                "while the shards walk with shard-local ids")
        if budget_cfg != self.beam_budget:
            raise ValueError(
                "staged distributed serving needs the engine's budget_cfg "
                f"to equal the backend's beam_budget; got {budget_cfg} vs "
                f"{self.beam_budget}")
        a = self.arrays
        return self._probe_step(a["adj"], a["codes"], a["vectors"],
                                a["centroids"], ctxs, a["entries"],
                                *self._laws(), active_count=active_count)

    def continue_fn(self, budget_cfg):
        a = self.arrays

        def cont(sub_state, sub_queries, sub_budgets, sub_hop_limits):
            return self._continue_step(
                a["adj"], a["codes"], a["vectors"], a["centroids"],
                sub_state, sub_queries, sub_budgets, sub_hop_limits,
                self.shard_ok)

        return cont

    def schedule_budgets(self, budgets_np: np.ndarray) -> np.ndarray:
        """Per-query budget for host scheduling: the mean over shards (the
        expected work a lane adds to each shard's continue).  The continue
        always receives the raw per-shard grants."""
        return np.rint(budgets_np.mean(axis=1)).astype(np.int32)

    def finish(self, queries, parts, k: int, *, q_lid, budgets_np,
               prefetch=None) -> BatchResult:
        d2, shard_ids, local_ids, hops, evals = parts
        sid = shard_ids.astype(np.int64)
        lid = local_ids.astype(np.int64)
        return BatchResult(
            ids=sid * self.rows_per_shard + lid, d2=d2,
            stats=search_mod.SearchStats(hops=hops, dist_evals=evals),
            astats=search_mod.AdaptiveStats(
                q_lid=torch.as_tensor(q_lid).cpu().numpy(),
                budget=budgets_np),
            extras={"shard_ids": sid, "local_ids": lid})


@dataclasses.dataclass
class _InFlight:
    """One admitted batch whose device work is dispatched, not collected.
    ``backend`` is a shallow snapshot taken at dispatch, so a backend
    ``update`` between stages never mixes two index versions inside one
    flight."""

    queries: Any
    backend: Any = None
    excl: Any = None
    ctxs: Any = None
    probe_state: Any = None
    budgets: Any = None
    hop_limits: Any = None
    q_lid: Any = None
    handles: Any = None        # fixed-beam / monolithic: the walk's outputs
    budgets_np: Any = None     # filled by the schedule stage
    ceilings: tuple[int, ...] | None = None
    dispatched: Any = None
    event: Any = None          # CUDA event after the flight's device work
    probe_event: Any = None    # CUDA event right after the probe and grant
    active_count: Any = None   # the walks' counter, read on the host
    parts: Any = None          # prefetch stage: continue outputs, host numpy
    prefetch: Any = None       # prefetch stage: the slow tier's fetch future
    walk_prefetch: Any = None  # future of the first-frontier adjacency reads


# Memory cached for an engine's partial stream when the engine is built.
# The caching allocator keeps a pool per stream, so a cold stream's first
# allocation is a cudaMalloc, and that waited for the card's queued work:
# a cold engine's first partial came back only when the continue it
# hedges did.  One small and one large cached block let a partial
# allocate without it.
PARTIAL_RESERVE_BYTES = (512 << 10, 64 << 20)


def _reserve(stream, dev) -> None:
    """Allocate and free PARTIAL_RESERVE_BYTES on ``stream``: the blocks
    stay cached in its pool."""
    with torch.cuda.stream(stream):
        blocks = [torch.empty(n, dtype=torch.uint8, device=dev)
                  for n in PARTIAL_RESERVE_BYTES]
        del blocks


class SearchEngine:
    """One serving API over the backends, with a double-buffered pipeline.

    ``budget_cfg=None`` serves fixed-beam at ``beam_width``; an
    :class:`~repro_torch.core.search.AdaptiveBeamBudget` serves the adaptive
    engine (probe -> budget -> bucketed continue -> rerank), staged per
    batch.  ``num_buckets``: "auto" (on the CPU the bucket family per batch
    from the granted-budget histogram; on the card one continue program),
    an int >= 2 (fixed halving family) or None/1 (one continue program).
    Scheduling never changes results.
    """

    def __init__(self, backend, budget_cfg=None, *, k: int = 10,
                 beam_width: int = 48, max_hops: int = 2048,
                 num_buckets: int | str | None = "auto",
                 pad_quantum: int = 4, coalesce_lanes: int | None = None):
        self.backend = backend
        self.budget_cfg = budget_cfg
        self.k = k
        self.beam_width = beam_width
        self.max_hops = max_hops
        self.num_buckets = num_buckets
        self.pad_quantum = pad_quantum
        self.coalesce_lanes = coalesce_lanes
        self._close_lock = threading.Lock()
        self._closed = False
        dev = backend.device
        cuda = dev.type == "cuda"
        self._stream = torch.cuda.Stream(dev) if cuda else None
        self._partial_stream = torch.cuda.Stream(dev) if cuda else None
        if cuda:
            _reserve(self._partial_stream, dev)

    # ------------------------------------------------------------- serving

    def search(self, queries, *, filter=None) -> BatchResult:
        """Serve one batch, all stages back to back.  ``filter`` is a boolean
        allowed mask over the index's nodes, (n,) or (Q, n), enforced
        in-graph: out-of-filter nodes never enter the beam."""
        f = self._dispatch(queries, filter)
        if self._walk_prefetching():
            f = self._walk_prefetch(f)
        f = self._schedule(f)
        if self._prefetching():
            f = self._prefetch(f)
        return self._gather(f)

    def search_batches(self, batches: Iterable, *,
                       filter=None) -> Iterator[BatchResult]:
        """Serve a stream of batches, double-buffered: batch i+1's admission
        and probe are dispatched before batch i is scheduled, and the oldest
        batch is gathered after that.  One result per input batch, in order
        (coalesced micro-batches are split back).  ``filter``: one shared
        (n,) mask, or one entry per batch ((n,), (Q_b, n) or None)."""
        pairs = self._with_filters(batches, filter)
        if not self.coalesce_lanes or self.coalesce_lanes <= 1:
            yield from self._stream_pairs(pairs)
            return
        groups: list[list[int]] = []
        for res in self._stream_pairs(self._coalesced(pairs, groups)):
            sizes = groups.pop(0)
            if len(sizes) == 1:
                yield res
            else:
                yield from _split_result(res, sizes)

    def _with_filters(self, batches: Iterable, flt) -> Iterator:
        if flt is None:
            for qb in batches:
                yield np.asarray(qb), None
            return
        if isinstance(flt, (np.ndarray, torch.Tensor, list, tuple)):
            try:
                shared = np.asarray(flt)
            except ValueError:       # ragged per-batch list
                shared = None
            if (shared is not None and shared.ndim == 1
                    and shared.dtype != object):
                shared = shared.astype(bool)
                for qb in batches:
                    yield np.asarray(qb), shared
                return
        for qb, m in zip(batches, flt):
            yield np.asarray(qb), None if m is None else np.asarray(m)

    def _coalesced(self, pairs: Iterable, groups: list) -> Iterator:
        """Merge consecutive (batch, mask) pairs until ``coalesce_lanes``
        lanes; record each flushed group's per-batch sizes in ``groups``."""
        pend: list[np.ndarray] = []
        pend_m: list = []
        lanes = 0

        def flush():
            groups.append([b.shape[0] for b in pend])
            qb = pend[0] if len(pend) == 1 else np.concatenate(pend)
            if all(m is None for m in pend_m):
                return qb, None
            n = self.backend.num_nodes()
            rows = [np.broadcast_to(
                        np.ones(n, bool) if m is None else m.astype(bool),
                        (b.shape[0], n))
                    for b, m in zip(pend, pend_m)]
            return qb, np.concatenate(rows)

        for qb, m in pairs:
            pend.append(qb)
            pend_m.append(m)
            lanes += qb.shape[0]
            if lanes >= self.coalesce_lanes:
                yield flush()
                pend, pend_m, lanes = [], [], 0
        if pend:
            yield flush()

    def _stream_pairs(self, pairs: Iterable) -> Iterator[BatchResult]:
        """The double-buffered pipeline core: each new dispatch advances
        every in-flight batch one stage, newest first, and the oldest
        finished batch is gathered.  A disk slow tier adds the prefetch
        stage, so three batches are in flight: batch i's probe, batch i-1's
        continue and batch i-2's block reads.  The out-of-core backend adds
        the walk-prefetch stage first: a batch's first-frontier reads go to
        the tier's workers one stage before its continue."""
        stages = [self._schedule]
        if self._walk_prefetching():
            stages.insert(0, self._walk_prefetch)
        if self._prefetching():
            stages.append(self._prefetch)
        flight: list[list] = []

        def advance() -> BatchResult | None:
            done = None
            for ent in reversed(flight):
                si, f = ent
                if si < len(stages):
                    ent[1] = stages[si](f)
                    ent[0] = si + 1
                else:
                    done = self._gather(f)
            if done is not None:
                flight.pop(0)
            return done

        for qb, flt in pairs:
            new = self._dispatch(qb, flt)
            res = advance()
            flight.append([0, new])
            if res is not None:
                yield res
        while flight:
            res = advance()
            if res is not None:
                yield res

    # -------------------------------------------- front-door dispatch seam

    def begin(self, queries, *, filter=None) -> _InFlight:
        """The dispatch stage alone (admission + probe, or the whole
        fixed-beam walk); pair with :meth:`finish_from`.  Staged, it waits
        for nothing on the card (see the module docstring)."""
        return self._dispatch(queries, filter)

    def finish_from(self, f: _InFlight) -> BatchResult:
        """Run the remaining stages of a :meth:`begin` flight; ``begin`` +
        ``finish_from`` is exactly :meth:`search`."""
        if self._staged() and f.dispatched is None:
            if self._walk_prefetching() and f.walk_prefetch is None:
                f = self._walk_prefetch(f)
            f = self._schedule(f)
        if self._prefetching() and f.prefetch is None:
            f = self._prefetch(f)
        return self._gather(f)

    @property
    def supports_partial(self) -> bool:
        return self._staged() and hasattr(self.backend, "partial_parts")

    def partial_result(self, f: _InFlight) -> BatchResult:
        """Best-so-far result at the probe horizon: the probe beam reranked
        through the normal finish path.  The flight is not consumed."""
        if not self.supports_partial:
            raise ValueError("partial results need a staged engine")
        with self._on_stream(self._partial_stream):
            if f.probe_event is not None:
                self._partial_stream.wait_event(f.probe_event)
            parts = tuple(a.cpu().numpy()
                          for a in f.backend.partial_parts(f.probe_state))
            self._check_probe(f)
            budgets_np = (f.budgets_np if f.budgets_np is not None
                          else f.budgets.cpu().numpy())
            res = f.backend.finish(f.queries, parts, self.k, q_lid=f.q_lid,
                                   budgets_np=budgets_np)
        res.extras["partial"] = True
        return res

    # ------------------------------------------------------ pipeline stages

    def _on_stream(self, stream=None):
        stream = self._stream if stream is None else stream
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    @staticmethod
    def _check_probe(f: _InFlight) -> None:
        """The read of the probe walk's counter that ``begin`` left to the
        first host read of the flight."""
        if f.active_count is not None:
            search_mod.check_converged(f.active_count)

    def _mark(self, f: _InFlight) -> _InFlight:
        if self._stream is not None:
            f.event = torch.cuda.Event()
            f.event.record(self._stream)
        return f

    def _pack_filter(self, flt, nq: int):
        """Exclusion words of an allowed mask: a (Q, n) mask packs row by
        row; a shared (n,) mask packs once into one row of words, expanded
        to (Q, ceil(n/32)) on the device (a view: the walk clones it).
        Copied up without a host sync (:func:`_to_device`)."""
        if flt is None:
            return None
        if not hasattr(self.backend, "num_nodes"):
            raise NotImplementedError(
                "filtered search is not supported on this backend (no "
                "global node-id view; see DistributedBackend.probe)")
        n = self.backend.num_nodes()
        allowed = np.asarray(flt, dtype=bool)
        shared = allowed.ndim == 1 and allowed.shape == (n,)
        if not shared and allowed.shape != (nq, n):
            raise ValueError(f"filter mask shape {allowed.shape} != "
                             f"({nq}, {n})")
        words = _to_device(search_mod.pack_filter(allowed, n, device="cpu"),
                           self.backend.device)
        return words.expand(nq, -1) if shared else words

    def _dispatch(self, queries, flt=None) -> _InFlight:
        """Admission and probe (or the whole fixed-beam walk, or a
        monolithic backend's whole step) on the engine's stream, waiting for
        nothing on the card: the copies go up through pinned memory, and
        the walks' counter is left for the first host read of the flight
        (:meth:`_schedule`, :meth:`partial_result` or :meth:`_collect`)."""
        backend = copy.copy(self.backend)
        queries = np.array(queries, dtype=np.float32)   # owned, writable
        with self._on_stream():
            if self._stream is not None:
                self._stream.wait_stream(
                    torch.cuda.current_stream(backend.device))
            excl = self._pack_filter(flt, queries.shape[0])
            q = _to_device(queries, backend.device)
            left = torch.zeros((1,), dtype=torch.int32, device=q.device)
            if not self._staged():
                if hasattr(backend, "dispatch"):     # filters refused above
                    handles = backend.dispatch(q, active_count=left)
                else:
                    handles = backend.fixed(q, beam_width=self.beam_width,
                                            max_hops=self.max_hops, k=self.k,
                                            excl=excl, active_count=left)
                return self._mark(_InFlight(queries=queries, backend=backend,
                                            excl=excl, handles=handles,
                                            active_count=left))
            ctxs = backend.admit(q)
            probe_state, budgets, hop_limits, q_lid = backend.probe(
                ctxs, self.budget_cfg, excl=excl, active_count=left)
        f = self._mark(_InFlight(
            queries=queries, backend=backend, excl=excl, ctxs=ctxs,
            probe_state=probe_state, budgets=budgets, hop_limits=hop_limits,
            q_lid=q_lid, active_count=left))
        f.probe_event = f.event
        return f

    def _schedule(self, f: _InFlight) -> _InFlight:
        """Host-bucket stage: sync the granted budgets, pick the bucket
        family, run every bucket's continue.  Fixed-beam flights pass."""
        if not self._staged():
            return f
        cfg = self.budget_cfg
        with self._on_stream():
            f.budgets_np = f.budgets.cpu().numpy()
            self._check_probe(f)
            sched = f.backend.schedule_budgets(f.budgets_np)
            f.ceilings = self._resolve_ceilings(sched, cfg)
            cont = f.backend.continue_fn(cfg)
            if f.ceilings is None or len(f.ceilings) <= 1:
                f.dispatched = cont(f.probe_state, f.ctxs, f.budgets,
                                    f.hop_limits)
            else:
                f.dispatched = pipe.dispatch_bucketed_continue(
                    cont, f.probe_state, f.ctxs, f.budgets, f.hop_limits,
                    f.ceilings, budgets_np=sched, quantum=self.pad_quantum)
        return self._mark(f)

    def _walk_prefetch(self, f: _InFlight) -> _InFlight:
        """Out-of-core stage: submit the reads of the continue's first
        frontier (at most the backend's ``io_depth`` nodes) to the tier's
        workers, where they land in its cache while other batches run.
        Cache warm-up only; results never depend on it."""
        with self._on_stream():
            f.walk_prefetch = f.backend.prefetch_walk(
                f.probe_state, f.budgets, f.hop_limits)
        return f

    def _prefetch(self, f: _InFlight) -> _InFlight:
        """Disk-tier stage: wait for the flight's continue work (its event),
        copy the continue outputs to the host and submit the rerank's block
        reads to the tier's worker pool.  It runs after the next batch's
        continue is queued, so the reads overlap that walk; the gather joins
        the future one stage later."""
        if f.event is not None:
            f.event.synchronize()
        with self._on_stream():
            f.parts = self._continue_parts(f)
        f.prefetch = f.backend.prefetch_rerank(f.parts)
        return f

    def _continue_parts(self, f: _InFlight) -> tuple:
        if f.parts is not None:
            return f.parts
        if f.ceilings is None or len(f.ceilings) <= 1:
            return tuple(a.cpu().numpy() for a in f.dispatched)
        return pipe.gather_bucketed_continue(f.budgets_np.shape[0],
                                             f.dispatched)

    def _gather(self, f: _InFlight) -> BatchResult:
        """Collection stage: wait for the flight's device work, pull the
        results, finish (rerank), restore query order.  Then kick one
        non-blocking promotion tick of a disk tier's hot tier, which digests
        the frequencies this batch recorded while later batches run."""
        res = self._collect(f)
        if f.walk_prefetch is not None:
            f.walk_prefetch.result()     # a warm-up, read for its errors
        self.backend.promotion_tick()
        return res

    def _collect(self, f: _InFlight) -> BatchResult:
        if f.event is not None:
            f.event.synchronize()
        with self._on_stream():
            if not self._staged():
                self._check_probe(f)
                if hasattr(f.backend, "collect"):
                    return f.backend.collect(f.handles)
                ids, d2, stats, astats = f.handles
                return BatchResult(ids=ids.cpu().numpy(),
                                   d2=d2.cpu().numpy(),
                                   stats=_host_stats(stats), astats=astats,
                                   extras=f.backend.finish_extras())
            res = f.backend.finish(f.queries, self._continue_parts(f), self.k,
                                   q_lid=f.q_lid, budgets_np=f.budgets_np,
                                   prefetch=f.prefetch)
        res.ceilings = f.ceilings
        return res

    def _staged(self) -> bool:
        return self.budget_cfg is not None and self.backend.staged

    def _prefetching(self) -> bool:
        """Whether the pipeline runs the disk prefetch stage."""
        return self._staged() and self.backend.prefetches

    def _walk_prefetching(self) -> bool:
        """Whether the pipeline runs the out-of-core walk-prefetch stage."""
        return (self._staged()
                and getattr(self.backend, "walk_prefetches", False))

    # ------------------------------------------------------ live reconfigure

    def recalibrate(self, queries=None, gt_ids=None, *,
                    recall_target: float = 0.95, joint: bool = False,
                    sample: int = 256, seed: int = 0,
                    eval_recall: Callable | None = None,
                    make_eval: Callable | None = None, **fit_kw):
        """Refit the budget law against ``recall_target`` and deploy it.

        ``joint=True`` runs the joint (lam, l_min) fit
        (:func:`repro_torch.core.calibrate.calibrate_budget_law_joint`),
        otherwise the lam bisection of
        :func:`~repro_torch.core.calibrate.calibrate_budget_law`.  The
        evaluators default to the backend's own recall measurement on a
        held-out sample of ``queries`` / ``gt_ids``; ``eval_recall`` /
        ``make_eval`` override them.  Returns the
        :class:`~repro_torch.core.calibrate.CalibrationResult`; the fitted
        config is live on return.
        """
        if self.budget_cfg is None:
            raise ValueError("recalibrate() needs an adaptive engine "
                             "(budget_cfg is None)")
        base = self.budget_cfg
        if joint:
            if make_eval is None:
                if queries is None or gt_ids is None:
                    raise ValueError("joint recalibration needs queries + "
                                     "gt_ids (or make_eval)")

                def make_eval(cfg):
                    return self.backend.recall_eval(
                        queries, gt_ids, k=self.k, sample=sample, seed=seed,
                        base_cfg=cfg)
            result = calib.calibrate_budget_law_joint(
                make_eval, base, recall_target, **fit_kw)
        else:
            if eval_recall is None:
                if queries is None or gt_ids is None:
                    raise ValueError("recalibration needs queries + gt_ids "
                                     "(or eval_recall)")
                eval_recall = self.backend.recall_eval(
                    queries, gt_ids, k=self.k, sample=sample, seed=seed,
                    base_cfg=base)
            result = calib.calibrate_budget_law(
                eval_recall, base, recall_target, **fit_kw)
        self.budget_cfg = result.budget_cfg(base)
        return result

    def update_backend(self, *args, **kw) -> None:
        """Swap refreshed index arrays into the live backend (see the
        backend's ``update``); a replaced disk tier is closed there."""
        self.backend.update(*args, **kw)

    def close(self) -> None:
        """Release backend-owned threads (a disk tier's workers).
        Idempotent and safe from any thread, also while a stream is in
        flight: exactly one caller closes the backend, and a closed disk
        tier still serves its reads synchronously, so in-flight batches
        complete with the same results."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self.backend.close()

    def _resolve_ceilings(self, budgets_np, cfg) -> tuple[int, ...] | None:
        if self.num_buckets == "auto":
            # On the card a frozen lane costs the kernel one early return, so
            # the padded lanes buckets spare are free there and each extra
            # bucket is one more hop loop: one continue program is cheapest.
            if self.backend.device.type == "cuda":
                return None
            return pipe.auto_bucket_ceilings(
                budgets_np, cfg, quantum=self.pad_quantum,
                launch_cost_hops=getattr(self.backend, "launch_cost_hops",
                                         pipe.BUCKET_LAUNCH_COST_HOPS))
        if self.num_buckets is None or self.num_buckets <= 1:
            return None
        return search_mod.budget_bucket_ceilings(cfg.l_min, cfg.l_max,
                                                 self.num_buckets)
