"""Live index mutation: the delta tier and the merge lifecycle (port of
:mod:`repro.index.delta`).

An LSM-style two-tier structure over the read-only serving stack:

  base tier   the last *published* index, immutable, served by the normal
              :class:`repro_torch.serving.SearchEngine` (PQ-routed walk and
              slow-tier rerank, in memory or from a block store);
  delta tier  :class:`DeltaTier`, an overlay absorbing inserts and deletes.
              Inserts are wired into a private *combined* graph (base
              adjacency plus rows for the new nodes) by Online-MCGI's
              :func:`repro_torch.core.online._rewire_batch_online` (a walk
              towards the node's own vector, its LID from that beam, an
              alpha(u) prune) and mirrored into their destinations with
              re-pruning.  Deletes are tombstones; nothing is unlinked.

:meth:`LiveIndex.search` fans out over both tiers: the base engine with the
base tombstones excluded in-graph, an exact scan of the live delta rows
(:meth:`DeltaTier.delta_topk`, the ``l2_distance`` and ``topk`` kernels on
the card) and the full-precision rerank over both pools.  At a merge
boundary (empty delta, no tombstones) it returns the engine's result
itself, so it is bit-identical to a fresh build of the same rows.

:meth:`LiveIndex.merge` rebuilds the live rows from scratch with
:func:`~repro_torch.core.online.build_online_mcgi` (deterministic), trains a
fresh PQ tier, publishes a ``live.g{generation}.blocks`` store (block-aware
layout, atomic rename) and swaps it into the engine; external ids stay
stable across merges.

Two choices differ from the reference, neither in any result:

* a merge publishes the engine's new backend, its budget law and the new
  delta state under one lock that each search holds while it dispatches,
  so no search pairs the new index with the old id map (the reference
  swaps the backend first and the state after a recalibration);
* writes wait for a running merge, so no insert or delete is lost to the
  merge's snapshot of the live rows.
"""
from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import build as build_mod
from repro_torch.core import distance as dist_mod
from repro_torch.core import online as online_mod
from repro_torch.core import search as search_mod
from repro_torch.core.types import GraphIndex

INVALID = build_mod.INVALID


@dataclasses.dataclass(frozen=True)
class _DeltaArrays:
    """One consistent view of the combined graph, replaced as a whole."""

    x: torch.Tensor          # (N, D) base rows then inserted rows
    adj: torch.Tensor        # (N, R) int32
    alpha: torch.Tensor      # (N,)
    lid: torch.Tensor        # (N,)
    tombstone: np.ndarray    # (N,) bool, host


class DeltaTier:
    """Mutable overlay over an immutable base :class:`GraphIndex`.

    Holds the combined state (base vectors and adjacency plus the delta
    nodes' rows, per-node alpha and LID, tombstones).  The tensors it
    receives are shared with the serving engine and are never written:
    each insert chunk builds new tensors (copy-on-extend), wires them, and
    publishes them together by one assignment, so a reader on another
    thread sees one chunk's state or the next, never half of one.

    The population statistics (mu, sigma) and the entry are frozen from the
    base build (Algorithm 2's bootstrap is not re-run per insert).
    """

    def __init__(self, x_base, graph: GraphIndex,
                 cfg: build_mod.BuildConfig):
        dev = graph.adj.device
        self.cfg = cfg
        x = torch.as_tensor(x_base, dtype=torch.float32, device=dev)
        self.n_base = int(x.shape[0])
        self.mu, self.sigma, self.entry = graph.mu, graph.sigma, graph.entry
        self._arr = _DeltaArrays(x=x, adj=graph.adj, alpha=graph.alpha,
                                 lid=graph.lid,
                                 tombstone=np.zeros(self.n_base, bool))

    # ------------------------------------------------------------ properties

    x = property(lambda self: self._arr.x)
    adj = property(lambda self: self._arr.adj)
    alpha = property(lambda self: self._arr.alpha)
    lid = property(lambda self: self._arr.lid)
    tombstone = property(lambda self: self._arr.tombstone)

    @property
    def device(self) -> torch.device:
        return self._arr.x.device

    @property
    def n(self) -> int:
        """Combined node count (base + delta, tombstones included)."""
        return int(self._arr.x.shape[0])

    @property
    def n_delta(self) -> int:
        return self.n - self.n_base

    @property
    def live_mask(self) -> np.ndarray:
        return ~self._arr.tombstone

    def live_base_mask(self) -> np.ndarray | None:
        """Allowed mask over the base nodes for the base engine's in-graph
        filter; None while no base node is tombstoned."""
        base = self._arr.tombstone[:self.n_base]
        return None if not base.any() else ~base

    # ------------------------------------------------------------- mutation

    def insert(self, vecs) -> np.ndarray:
        """Absorb vectors; returns their combined-local ids.

        Each ``cfg.batch`` chunk enters edge-less with the midpoint alpha
        and LID mu, is wired by one online rewire against the current
        combined graph, and its new edges are mirrored with re-pruning."""
        vecs = torch.as_tensor(vecs, dtype=torch.float32, device=self.device)
        if vecs.ndim == 1:
            vecs = vecs[None]
        m, cfg, first = vecs.shape[0], self.cfg, self.n
        clock = build_mod._phase_clock(None, self.device)
        for lo in range(0, m, cfg.batch):
            chunk = vecs[lo:lo + cfg.batch]
            a, real, dev = self._arr, chunk.shape[0], self.device
            n0 = a.x.shape[0]
            x = torch.cat([a.x, chunk])
            adj = torch.cat([a.adj, torch.full((real, a.adj.shape[1]),
                                               INVALID, dtype=torch.int32,
                                               device=dev)])
            alpha = torch.cat([a.alpha, torch.full(
                (real,), 0.5 * (cfg.alpha_min + cfg.alpha_max),
                dtype=torch.float32, device=dev)])
            lid = torch.cat([a.lid, self.mu.expand(real)])
            ids = torch.arange(n0, n0 + real, dtype=torch.int32, device=dev)
            online_mod._wire(x, adj, alpha, lid, self.mu, self.sigma,
                             self.entry, ids, cfg, clock)
            self._arr = _DeltaArrays(
                x=x, adj=adj, alpha=alpha, lid=lid,
                tombstone=np.concatenate([a.tombstone,
                                          np.zeros(real, bool)]))
        return np.arange(first, first + m, dtype=np.int64)

    def delete(self, local_ids) -> None:
        """Tombstone combined-local ids (base or delta).  Edges stay: a
        tombstoned node is still traversed by the filtered walk, never
        returned."""
        self._arr.tombstone[np.asarray(local_ids, dtype=np.int64)] = True

    # -------------------------------------------------------------- queries

    def delta_topk(self, queries, k: int):
        """Exact top-k over the *live delta* rows (the memtable scan):
        one :func:`repro_torch.core.distance.brute_force_topk`.

        Returns (ids (Q, k) int64 combined-local, d2 (Q, k)) on the tier's
        device, INVALID/inf padded when fewer than k delta rows are live;
        ties go to the lower id.  An inserted vector is findable the moment
        ``insert`` returns because of this scan, not walk luck."""
        a, dev = self._arr, self.device
        q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        ids = torch.full((q.shape[0], k), INVALID, dtype=torch.int64,
                         device=dev)
        d2 = torch.full((q.shape[0], k), torch.inf, dtype=torch.float32,
                        device=dev)
        live = np.flatnonzero(~a.tombstone[self.n_base:]) + self.n_base
        if live.size == 0:
            return ids, d2
        live_t = torch.as_tensor(live, device=dev)
        d, pos = dist_mod.brute_force_topk(q, a.x[live_t], k)
        ok = pos >= 0
        ids = torch.where(ok, live_t[pos.clamp_min(0).long()], ids)
        return ids, torch.where(ok, d, d2)

    def search_exact(self, queries, *, beam_width: int, k: int,
                     max_hops: int = 2048):
        """Exact in-graph walk over the live combined graph (base and delta
        nodes in one beam, tombstones excluded in-graph): the quality view
        of the incremental edge repair.  Returns (ids, d2, stats) in
        combined-local ids."""
        a, dev = self._arr, self.device
        q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        excl = None
        if a.tombstone.any():
            excl = search_mod.pack_filter(~a.tombstone, a.x.shape[0],
                                          dev).expand(q.shape[0], -1)
        return search_mod.beam_search_exact(
            a.x, a.adj, q, self.entry, beam_width=beam_width,
            max_hops=max_hops, k=k, excl=excl)


@dataclasses.dataclass
class _LiveState:
    """One generation's (delta, ext_of) pair, replaced as a whole at a
    merge's publish.  ``ext_of`` (combined-local id -> external id) is
    extended before the delta, so it always covers the delta's ids."""

    delta: DeltaTier
    ext_of: np.ndarray
    generation: int


class _MergeThread(threading.Thread):
    """A background merge; ``join`` re-raises the merge's exception."""

    def __init__(self, merge):
        super().__init__(name="delta-merge", daemon=True)
        self._merge = merge
        self.generation: int | None = None
        self.error: Exception | None = None

    def run(self) -> None:
        try:
            self.generation = self._merge()
        except Exception as e:   # handed to the joining thread
            self.error = e

    def join(self, timeout: float | None = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


class LiveIndex:
    """Mutable serving front: base engine + delta tier + merge compaction.

    ``store_dir`` serves the base engine's slow tier from a block store
    (:class:`~repro_torch.index.disk.BlockSlowTier`); each merge publishes a
    generation-numbered store and swaps it in with ``update_backend``
    (in-flight requests finish on their dispatch-time backend snapshot).
    Without it the slow tier is the device rows.

    ``calib`` (queries) arms drift-triggered recalibration: when a merge
    moves the population's mean LID by more than ``drift_threshold``, the
    budget law is refit against brute-force ground truth over the merged
    rows before the new generation is published.

    ``build_timings`` holds the seconds of each phase of the last base
    build: the online build's phases, ``pq_tier``, and with a store
    ``layout`` and ``store``.
    """

    def __init__(self, x0, cfg: build_mod.BuildConfig, *,
                 budget_cfg=None, k: int = 10, beam_width: int = 48,
                 max_hops: int = 2048, m_pq: int = 8, pq_seed: int = 0,
                 store_dir: str | pathlib.Path | None = None,
                 nodes_per_block: int = 4, merge_threshold: int = 256,
                 calib=None, recall_target: float = 0.95,
                 drift_threshold: float = 0.25,
                 engine_kw: dict | None = None, device="cuda"):
        from repro_torch.serving import engine as engine_mod

        self.device = resolve_device(device)
        self.cfg = cfg
        self.k = k
        self.beam_width = beam_width
        self.max_hops = max_hops
        self.m_pq = m_pq
        self.pq_seed = pq_seed
        self.budget_cfg = budget_cfg
        self.store_dir = None if store_dir is None else pathlib.Path(store_dir)
        self.nodes_per_block = nodes_per_block
        self.merge_threshold = merge_threshold
        self.calib = None if calib is None else np.asarray(calib, np.float32)
        self.recall_target = recall_target
        self.drift_threshold = drift_threshold
        self._engine_mod = engine_mod
        self._engine_kw = dict(engine_kw or {})
        self._merge_lock = threading.Lock()     # one merge; writes wait
        self._publish_lock = threading.Lock()   # backend + state together
        self.build_timings: dict[str, float] = {}
        self.lineage: dict[str, Any] = {"generation": 0, "merges": 0,
                                        "inserts": 0, "deletes": 0}

        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        graph, index, slow_tier = self._build_base(x0, generation=0)
        self.engine = engine_mod.SearchEngine(
            engine_mod.TieredBackend(index, slow_tier=slow_tier,
                                     device=self.device),
            budget_cfg, k=k, beam_width=beam_width, max_hops=max_hops,
            **self._engine_kw)
        self._state = _LiveState(
            delta=DeltaTier(x0, graph, cfg),
            ext_of=np.arange(x0.shape[0], dtype=np.int64), generation=0)
        self._next_ext = int(x0.shape[0])

    # ------------------------------------------------------------- plumbing

    def _build_base(self, x_new: torch.Tensor, generation: int):
        """Deterministic base build, PQ tier and (with ``store_dir``) the
        generation's block store in the block-aware packed layout."""
        from repro_torch.index import disk as disk_mod

        timings: dict[str, float] = {}
        clock = build_mod._phase_clock(timings, self.device)
        graph = online_mod.build_online_mcgi(x_new, self.cfg,
                                             device=self.device,
                                             timings=timings)
        with clock("pq_tier"):
            index = disk_mod.build_tiered_index(
                x_new, graph, m_pq=self.m_pq, seed=self.pq_seed,
                device=self.device)
        slow_tier = None
        if self.store_dir is not None:
            with clock("layout"):
                slot_of = build_mod.block_layout(graph, self.nodes_per_block)
            with clock("store"):
                slow_tier = disk_mod.open_or_build_slow_tier(
                    self.store_dir / f"live.g{generation}.blocks", index,
                    nodes_per_block=self.nodes_per_block, slot_of=slot_of)
        self.build_timings = timings
        return graph, index, slow_tier

    @property
    def generation(self) -> int:
        return self._state.generation

    @property
    def delta_size(self) -> int:
        d = self._state.delta
        return int(d.n_delta + d.tombstone.sum())

    @property
    def n_live(self) -> int:
        return int(self._state.delta.live_mask.sum())

    def _locate(self, ext_ids) -> np.ndarray:
        """External ids -> combined-local ids (``ext_of`` stays sorted:
        compaction keeps insertion order, inserts append)."""
        ext_of = self._state.ext_of
        ext_ids = np.asarray(ext_ids, dtype=np.int64)
        loc = np.searchsorted(ext_of, ext_ids)
        ok = (loc < ext_of.size) & (
            ext_of[np.minimum(loc, ext_of.size - 1)] == ext_ids)
        if not ok.all():
            raise KeyError(f"unknown/deleted external ids "
                           f"{ext_ids[~ok][:8].tolist()}")
        return loc

    # ------------------------------------------------------------- mutation

    def insert(self, vecs, *, auto_merge: bool = True) -> np.ndarray:
        """Insert vectors; returns their stable external ids.  With
        ``auto_merge`` the delta compacts once it reaches
        ``merge_threshold``."""
        vecs = torch.as_tensor(vecs, dtype=torch.float32, device=self.device)
        if vecs.ndim == 1:
            vecs = vecs[None]
        m = int(vecs.shape[0])
        with self._merge_lock:
            st = self._state
            ext = np.arange(self._next_ext, self._next_ext + m,
                            dtype=np.int64)
            self._next_ext += m
            st.ext_of = np.concatenate([st.ext_of, ext])
            st.delta.insert(vecs)
            self.lineage["inserts"] += m
        if auto_merge and self.delta_size >= self.merge_threshold:
            self.merge()
        return ext

    def delete(self, ext_ids) -> None:
        """Tombstone by external id: excluded from every search from now on
        (in-graph on the base tier, masked on the delta scan), reclaimed at
        the next merge."""
        with self._merge_lock:
            self._state.delta.delete(self._locate(ext_ids))
            self.lineage["deletes"] += int(np.asarray(ext_ids).size)

    # -------------------------------------------------------------- serving

    def search(self, queries, k: int | None = None):
        """Fan-out search over base + delta; returns (ext_ids, d2), host.

        At a merge boundary this is exactly the engine's result.  Otherwise:
        the base engine with the base tombstones excluded in-graph, the
        exact delta scan, and the full-precision rerank of both (disjoint)
        pools, gathered on the device."""
        k = self.k if k is None else k
        queries = np.asarray(queries, dtype=np.float32)
        with self._publish_lock:
            st = self._state
            boundary = st.delta.n_delta == 0 and not st.delta.tombstone.any()
            flight = self.engine.begin(
                queries, filter=None if boundary
                else st.delta.live_base_mask())
        res = self.engine.finish_from(flight)
        if boundary:
            return _external(st.ext_of, res.ids), res.d2
        # Rows of x never change once appended, and ext_of grows before the
        # delta, so arrays read after the scan cover every id it returns.
        delta_ids, _ = st.delta.delta_topk(queries, k)
        x = st.delta.x
        q = torch.as_tensor(queries, device=x.device)
        cand = torch.cat([torch.as_tensor(res.ids, device=x.device).long(),
                          delta_ids], 1)
        ids, d2 = search_mod._rerank_from_vecs(cand, x[cand.clamp_min(0)], q,
                                               k)
        return _external(st.ext_of, ids.cpu().numpy()), d2.cpu().numpy()

    def search_local(self, queries, k: int | None = None):
        """Like :meth:`search` but in combined-local ids."""
        ext, d2 = self.search(queries, k)
        ext_of = self._state.ext_of
        loc = np.where(ext >= 0, np.searchsorted(ext_of, np.maximum(ext, 0)),
                       INVALID)
        return loc, d2

    # ---------------------------------------------------------------- merge

    def merge(self) -> int:
        """Compact live content into a new published base generation.

        A from-scratch build over the live rows in insertion order, a fresh
        PQ tier, the packed block store, the drift-triggered refit, then
        one publish of the engine's backend, its law and the new delta
        state (the build's stream synchronised first, since the engine
        runs on its own stream).  Returns the new generation number.
        """
        with self._merge_lock:
            st = self._state
            gen = st.generation + 1
            live = np.flatnonzero(st.delta.live_mask)
            x_new = st.delta.x[torch.as_tensor(live, device=self.device)]
            old_mu = float(st.delta.mu)
            graph, index, slow_tier = self._build_base(x_new, generation=gen)
            new_mu = float(graph.mu)
            law = None
            if (self.budget_cfg is not None and self.calib is not None
                    and abs(new_mu - old_mu) > self.drift_threshold):
                gt = _brute_force_gt(x_new, self.calib, self.k)
                fit = self._engine_mod.SearchEngine(
                    self._engine_mod.TieredBackend(index,
                                                   device=self.device),
                    self.engine.budget_cfg, k=self.k)
                fit.recalibrate(self.calib, gt,
                                recall_target=self.recall_target)
                law = fit.budget_cfg
                self.lineage["recalibrations"] = (
                    self.lineage.get("recalibrations", 0) + 1)
            state = _LiveState(delta=DeltaTier(x_new, graph, self.cfg),
                               ext_of=st.ext_of[live].copy(), generation=gen)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            with self._publish_lock:
                self.engine.update_backend(index, slow_tier=slow_tier)
                if law is not None:
                    self.engine.budget_cfg = law
                self._state = state
            self.lineage.update(generation=gen,
                                merges=self.lineage["merges"] + 1,
                                live=int(live.size), mu=new_mu)
            return gen

    def merge_async(self) -> threading.Thread:
        """Run :meth:`merge` on a background thread while traffic flows;
        join the returned thread to wait for the publish (``join``
        re-raises a failed merge's exception).  The build shares the
        interpreter lock with the serving thread."""
        t = _MergeThread(self.merge)
        t.start()
        return t

    def save(self, path) -> None:
        """Persist the current *base* generation with the lineage riding in
        the manifest (:func:`repro_torch.index.serializer.save_index`)."""
        from repro_torch.index import serializer

        disk = self.store_dir is not None
        serializer.save_index(
            path, self.engine.backend.index, version=2 if disk else 1,
            nodes_per_block=self.nodes_per_block if disk else 1,
            lineage=dict(self.lineage))

    def close(self) -> None:
        self.engine.close()


def _external(ext_of: np.ndarray, ids: np.ndarray) -> np.ndarray:
    ids = ids.astype(np.int64)
    return np.where(ids >= 0, ext_of[np.maximum(ids, 0)], INVALID)


def _brute_force_gt(x, queries, k: int) -> np.ndarray:
    """Exact top-k ids over ``x`` (recalibration ground truth), through
    :func:`repro_torch.core.distance.brute_force_topk`."""
    x = torch.as_tensor(x, dtype=torch.float32)
    q = torch.as_tensor(queries, dtype=torch.float32, device=x.device)
    return dist_mod.brute_force_topk(q, x, k)[1].cpu().numpy()
