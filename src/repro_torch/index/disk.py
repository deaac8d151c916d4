"""Two-tier disk-resident index (port of :mod:`repro.index.disk`, without
the out-of-core walk).

  fast tier : PQ codes (N, M) uint8 + adjacency (N, R) int32 on the card
  slow tier : full-precision vectors (N, D) float32 — device-memory rows
              (:class:`InMemorySlowTier`) or a block-aligned on-disk store
              (:class:`BlockSlowTier` over
              :class:`repro_torch.index.blockstore.BlockStore`: one aligned,
              checksummed record per node, vector + adjacency, read through
              a memmap)

Every node expansion counts as one slow-tier read (the per-query hop counter
of :class:`repro_torch.core.search.SearchStats`); :class:`DiskTierModel`
turns counted reads into modelled latency, and a :class:`BlockSlowTier`
measures them (``BlockStore.stats``).

The slow tier plugs in behind :class:`SlowTier`: serving swaps the block
store in through ``TieredBackend(index, slow_tier=BlockSlowTier(...))``.
The walk still runs on the card over the fast tier; only the rerank's fetch
moves to the host, and :func:`rerank_with_slow_tier` runs the in-memory
rerank's arithmetic on the fetched rows, so results are bit-identical
between the tiers.  :class:`BlockSlowTier` adds a pinned set and an LRU of
records with exact hit and miss counters, host-thread prefetch (the
engine's prefetch stage overlaps batch i's block reads with batch i+1's
walk), and an optional frequency-aware hot tier
(:class:`repro_torch.index.hot_tier.HotTier`).  The tier works on host
numpy only: its worker and promoter threads never touch the card.  The
out-of-core walk (adjacency read at walk time) is not ported yet.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Protocol

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import search as search_mod
from repro_torch.core.types import GraphIndex
from repro_torch.index.blockstore import BlockStore
from repro_torch.pq import PqCodebook, build_lut, pq_encode, train_pq


@dataclasses.dataclass(frozen=True)
class DiskTierModel:
    """Latency model for the slow tier (defaults: the paper's SATA SSD,
    ~90 us per random 4K read, queue depth 8)."""

    read_latency_us: float = 90.0
    queue_depth: int = 8

    def latency_us(self, reads, rerank_reads=0, *, overlapped: bool = False):
        """Modelled time of ``reads`` dependent expansions plus a rerank
        batch of ``rerank_reads`` independent fetches, issued queue_depth at
        a time; ``overlapped`` models the staged engine (max, not sum)."""
        serial = torch.as_tensor(reads, dtype=torch.float32) * self.read_latency_us
        rounds = torch.ceil(torch.as_tensor(rerank_reads, dtype=torch.float32)
                            / max(self.queue_depth, 1))
        rerank_time = rounds * self.read_latency_us
        if overlapped:
            return torch.maximum(serial, rerank_time)
        return serial + rerank_time


@dataclasses.dataclass(frozen=True)
class TieredIndex:
    """A disk-resident MCGI/Vamana index: graph + PQ fast tier + slow tier."""

    graph: GraphIndex
    codebook: PqCodebook
    codes: torch.Tensor     # (N, M) uint8 — fast tier
    vectors: torch.Tensor   # (N, D) float32 — slow tier rows

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def fast_tier_bytes(self) -> int:
        return (self.codes.numel() + self.graph.adj.numel() * 4
                + self.codebook.centroids.numel() * 4)

    def slow_tier_bytes(self) -> int:
        return self.vectors.numel() * 4


def build_tiered_index(x, graph: GraphIndex, m_pq: int = 16, seed: int = 0,
                       *, device="cuda") -> TieredIndex:
    """Train PQ (the PQ view zero-pads D to a multiple of ``m_pq``; L2 over
    zero dims is unchanged) and encode the fast tier; the slow tier keeps
    ``x``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    pad = (-x.shape[1]) % m_pq
    x_pq = F.pad(x, (0, pad)) if pad else x
    book = train_pq(x_pq, m=m_pq, seed=seed)
    return TieredIndex(graph=graph, codebook=book, codes=pq_encode(x_pq, book),
                       vectors=x)


def _query_luts(index: TieredIndex, queries: torch.Tensor) -> torch.Tensor:
    """Per-query ADC LUTs, zero-padding queries to the PQ-padded dim."""
    d_book = index.codebook.m * index.codebook.dsub
    if queries.shape[1] < d_book:
        queries = F.pad(queries, (0, d_book - queries.shape[1]))
    return build_lut(queries, index.codebook.centroids)


def search_tiered(index: TieredIndex, queries, beam_width: int, k: int = 10,
                  max_hops: int = 2048, rerank: bool = True, excl=None):
    """PQ-routed beam search with slow-tier rerank (the deployed path)."""
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=index.device)
    luts = _query_luts(index, queries)
    return search_mod.beam_search_pq(
        index.codes, luts, index.vectors, index.graph.adj, queries,
        index.graph.entry, beam_width=beam_width, max_hops=max_hops, k=k,
        rerank=rerank, excl=excl)


def search_tiered_adaptive(index: TieredIndex, queries,
                           budget_cfg: search_mod.AdaptiveBeamBudget,
                           k: int = 10, rerank: bool = True,
                           num_buckets: int | None = None, excl=None):
    """Per-query adaptive-beam serving path over one tiered index."""
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=index.device)
    luts = _query_luts(index, queries)
    return search_mod.beam_search_pq_adaptive(
        index.codes, luts, index.vectors, index.graph.adj, queries,
        index.graph.entry, budget_cfg=budget_cfg, k=k, rerank=rerank,
        num_buckets=num_buckets, excl=excl)


# --------------------------------------------------------------------------
# Pluggable slow tier: the rerank's batched node fetch, served from memory
# rows or from the block-aligned disk store.
# --------------------------------------------------------------------------


class SlowTier(Protocol):
    """What the serving rerank needs from a slow tier.

    ``fetch_beams(beam_ids (Q, L) int) -> (Q, L, D) float32``: the batched
    node fetch of the final beam.  Rows of INVALID (-1) lanes carry no
    information (the rerank masks their distances to inf): the in-memory
    tier clamps them to node 0, :class:`BlockSlowTier` zero-fills them and
    never counts them or reads a block for them.  ``is_disk`` tells the
    engine whether the fetch is worth hiding behind the next batch's walk.
    """

    is_disk: bool

    def fetch_beams(self, beam_ids: np.ndarray) -> np.ndarray: ...


class InMemorySlowTier:
    """The slow tier as full-precision rows in (device) memory."""

    is_disk = False

    def __init__(self, vectors: torch.Tensor):
        self.vectors = vectors

    def fetch_beams(self, beam_ids: torch.Tensor) -> torch.Tensor:
        """(Q, L) ids -> (Q, L, D) rows; INVALID lanes clamp to node 0 (the
        rerank masks their distances)."""
        return self.vectors[beam_ids.clamp_min(0).long()]


class BlockSlowTier:
    """Disk-resident slow tier over a
    :class:`~repro_torch.index.blockstore.BlockStore` (host numpy).

    * **record cache** — a bounded LRU of recently fetched records (vector
      and adjacency row) plus a statically pinned set (the entry-proximal
      nodes every walk funnels through).  Hit and miss counters are exact:
      each distinct valid node id of a fetch counts once, hit or miss;
      INVALID (-1) lanes are neither counted nor read.  Over a packed store
      (``nodes_per_block > 1``) a miss reads its whole I/O block and caches
      every record in it.
    * **prefetch** — :meth:`prefetch` (rerank beams) and
      :meth:`prefetch_adj` (adjacency rows) run the fetch on a lazily
      created worker pool of ``io_workers`` threads and return a future
      equal to the direct fetch.  :meth:`close` (also ``with``) shuts the
      pool down; a closed tier still serves, synchronously.
    * **frequency-aware hot tier** (``hot_nodes > 0``) — a
      :class:`repro_torch.index.hot_tier.HotTier` probed between the pinned
      set and the LRU, refilled by promotion ticks on its own thread
      (:meth:`promotion_tick`, non-blocking, at most one in flight;
      :meth:`drain_promotions` joins it).  ``hot_device_mirror`` copies its
      arrays to torch tensors on ``mirror_device`` after each tick.

    Thread safety: the cache and counters sit under a lock that is never
    held across block I/O (a second lock serialises store reads), so
    :meth:`stats`, read at every gather, returns while a prefetch read is
    in flight.  Concurrent fetches stay exact: each call counts its distinct
    valid ids once, wherever they are found.  Counters start at zero: the
    pinned-set load is construction, not traffic.  No thread of the tier
    touches the card, except the hot tier's mirror upload.
    """

    is_disk = True

    def __init__(self, store: BlockStore, cache_nodes: int = 4096,
                 pinned_ids=None, *, io_workers: int | None = None,
                 hot_nodes: int = 0, hot_chunk: int = 256,
                 freq_decay: float = 0.5, hot_device_mirror: bool = False,
                 mirror_device="cuda"):
        self.store = store
        self.cache_nodes = int(cache_nodes)
        # Prefetch pool width; None = unset (1, unless a consumer adopts a
        # better default via default_io_workers before the pool spins up).
        self.io_workers = io_workers
        # id -> (vector (D,) f32, adjacency (R,) i32)
        self._lru: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict())
        self._pinned: dict[int, tuple] = {}
        self._lock = threading.Lock()       # cache + counters; no I/O under it
        self._io_lock = threading.Lock()    # block-store reads
        self._pool = None                   # lazy: many tiers never prefetch
        self._closed = False
        self.hits = 0
        self.misses = 0
        # Per-call fetch wall times (us), bounded window — percentiles via
        # fetch_latency_us(), kept out of stats() (see there).
        self._fetch_us: "collections.deque[float]" = collections.deque(
            maxlen=65536)
        if pinned_ids is not None:
            ids = np.unique(np.asarray(pinned_ids, np.int64))
            if ids.size:
                vecs, adjs = store.read_many(ids)
                self._pinned = {int(i): (vecs[j].copy(), adjs[j].copy())
                                for j, i in enumerate(ids)}
        self._hot = None
        self._hot_future = None
        if hot_nodes > 0:
            from repro_torch.index.hot_tier import HotTier

            exclude = (np.fromiter(self._pinned, np.int64,
                                   len(self._pinned))
                       if self._pinned else None)
            # Private store handle: promotion I/O must share neither the
            # serving _io_lock nor the serving stream's I/O counters.
            self._hot = HotTier(BlockStore(store.path), store.n,
                                int(hot_nodes), chunk=hot_chunk,
                                decay=freq_decay, lock=self._lock,
                                exclude_ids=exclude,
                                device_mirror=hot_device_mirror,
                                mirror_device=mirror_device)
        store.reset_stats()   # serving counters exclude the pinned load

    # ------------------------------------------------------------- lifecycle

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, wait: bool = True) -> None:
        """Shut down the prefetch workers and the hot tier's promoter.
        Idempotent and safe under concurrent callers — engine teardown can
        race a server drain: exactly one caller claims the pool and the hot
        tier (later/parallel closes see them already taken).  The memmapped
        store stays readable — only the owned threads are torn down, so a
        closed tier still serves synchronous fetches, and in-flight streams
        keep working: :meth:`prefetch` / :meth:`prefetch_adj` degrade to
        completed-synchronously futures instead of raising (the pipeline
        loses its overlap, never its results).  Promotion ticks become
        no-ops."""
        with self._lock:
            already, self._closed = self._closed, True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait)
        if not already and self._hot is not None:
            self._hot.close(wait=wait)

    def __enter__(self) -> "BlockSlowTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def default_io_workers(self, n: int) -> None:
        """Adopt ``n`` prefetch workers unless the constructor pinned a
        count or the pool already exists (a consumer that overlaps several
        groups' reads sizes the pool to its group count)."""
        with self._lock:
            if self.io_workers is None and self._pool is None:
                self.io_workers = max(1, int(n))

    def _submit(self, fn, *args) -> "concurrent.futures.Future":
        """Submit ``fn(*args)`` to the prefetch pool; on a closed tier (or
        one closed between the check and the submit — teardown may race an
        in-flight stream) run it synchronously into a completed future
        instead.  The store stays readable after close, so degrading costs
        the overlap, never the result."""
        with self._lock:
            pool = None
            if not self._closed:
                if self._pool is None:
                    self._pool = concurrent.futures.ThreadPoolExecutor(
                        max_workers=max(1, int(self.io_workers or 1)),
                        thread_name_prefix="slow-tier-prefetch")
                pool = self._pool
        if pool is not None:
            try:
                return pool.submit(fn, *args)
            except RuntimeError:
                pass   # pool shut down after the check; fall through
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as e:
            fut.set_exception(e)
        return fut

    # ------------------------------------------------------------- promotion

    def promotion_tick(self):
        """Non-blocking: submit one hot-tier promotion round to the
        promoter thread (the engine calls this at every pipeline gather).
        At most one tick is in flight — if the previous one is still
        running, its future is returned unchanged, so a slow promotion can
        never pile up work.  Returns ``None`` without a hot tier or after
        :meth:`close`."""
        with self._lock:
            if self._hot is None or self._closed:
                return None
            fut = self._hot_future
            if fut is not None and not fut.done():
                return fut
            self._hot_future = self._hot.submit_tick()
            return self._hot_future

    def drain_promotions(self) -> None:
        """Join the in-flight promotion tick, if any — the determinism hook
        tests and benchmarks use between measured passes.  Serving never
        calls this; a promotion error would surface here."""
        fut = self._hot_future
        if fut is not None:
            fut.result()

    # ------------------------------------------------------------- fetching

    def fetch_records(
        self, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(vectors (len, D) f32, adj (len, R) i32) for a flat array of
        *valid* node ids (duplicates fine — each distinct id counts once
        toward hits/misses, block reads, and the hot tier's frequency
        score)."""
        t0 = time.perf_counter()
        ids = np.asarray(ids, np.int64).ravel()
        uniq, inverse = np.unique(ids, return_inverse=True)
        vecs = np.empty((uniq.size, self.store.d), np.float32)
        adjs = np.empty((uniq.size, self.store.r), np.int32)
        hot = self._hot
        with self._lock:                      # probe the cache, count
            if hot is not None:
                hot.freq[uniq] += 1.0         # EMA numerator; tick decays it
            missing: list[tuple[int, int]] = []
            for j, i in enumerate(uniq.tolist()):
                rec = self._pinned.get(i)
                if rec is None and (rec := self._lru.get(i)) is not None:
                    self._lru.move_to_end(i)
                if rec is not None:
                    vecs[j], adjs[j] = rec
                    continue
                # Hot tier: O(1) membership, dense-array copy, no dict.
                if hot is not None and (s := int(hot.slot[i])) >= 0:
                    vecs[j] = hot.vectors[s]
                    adjs[j] = hot.adj[s]
                    hot.hot_hits += 1
                    continue
                missing.append((j, i))
            self.hits += uniq.size - len(missing)
            self.misses += len(missing)
        if missing:
            miss_ids = np.asarray([i for _, i in missing], np.int64)
            if self.store.nodes_per_block > 1:
                # Block-granular read: cache every co-located record, so the
                # packed layout's co-expansions become hits.
                with self._io_lock:
                    got_ids, got_v, got_a = self.store.read_blocks(
                        self.store.io_block_of(miss_ids))
                rec_of = {int(i): (got_v[j].copy(), got_a[j].copy())
                          for j, i in enumerate(got_ids)}
                with self._lock:
                    for j, i in missing:
                        vecs[j], adjs[j] = rec_of[i]
                    if self.cache_nodes > 0:
                        for i, rec in rec_of.items():
                            if i not in self._pinned:
                                self._lru[i] = rec
                                self._lru.move_to_end(i)
                        while len(self._lru) > self.cache_nodes:
                            self._lru.popitem(last=False)
            else:
                with self._io_lock:          # block reads — cache lock free
                    got_v, got_a = self.store.read_many(miss_ids)
                with self._lock:             # insert what was read
                    for (j, i), v, a in zip(missing, got_v, got_a):
                        vecs[j], adjs[j] = v, a
                        if self.cache_nodes > 0:
                            self._lru[i] = (v.copy(), a.copy())
                            while len(self._lru) > self.cache_nodes:
                                self._lru.popitem(last=False)
        dt_us = (time.perf_counter() - t0) * 1e6
        with self._lock:
            self._fetch_us.append(dt_us)
        return vecs[inverse], adjs[inverse]

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """(len(ids), D) float32 for a flat array of valid node ids."""
        return self.fetch_records(ids)[0]

    def fetch_beams(self, beam_ids: np.ndarray) -> np.ndarray:
        """Batched rerank fetch.  INVALID (-1) lanes are masked out of
        counting and I/O and their rows zero-filled — the rerank masks their
        distances to inf regardless, but padding lanes must not inflate the
        node-0 counters or trigger real block reads."""
        beam_ids = np.asarray(beam_ids, np.int64)
        out = np.zeros((*beam_ids.shape, self.store.d), np.float32)
        valid = beam_ids >= 0
        if valid.any():
            out[valid] = self.fetch(beam_ids[valid])
        return out

    def fetch_adj(self, ids: np.ndarray) -> np.ndarray:
        """Adjacency rows: (..., R) int32, all-INVALID rows for INVALID
        lanes (no I/O for them)."""
        ids = np.asarray(ids, np.int64)
        out = np.full((*ids.shape, self.store.r), search_mod.INVALID,
                      np.int32)
        valid = ids >= 0
        if valid.any():
            out[valid] = self.fetch_records(ids[valid])[1]
        return out

    def prefetch(self, beam_ids: np.ndarray) -> "concurrent.futures.Future":
        """Submit :meth:`fetch_beams` to the worker pool; the engine joins
        the future one pipeline stage later, at rerank time."""
        return self._submit(self.fetch_beams, np.asarray(beam_ids))

    def prefetch_adj(self, ids: np.ndarray) -> "concurrent.futures.Future":
        """Submit :meth:`fetch_adj` to the worker pool."""
        return self._submit(self.fetch_adj, np.asarray(ids))

    # ---------------------------------------------------------- observability

    def stats(self) -> dict:
        """Cumulative cache + I/O counters (exact on a replayed stream).
        With a hot tier, promotion counters ride along — promotion I/O is
        accounted on the hot tier's private store handle, so ``blocks_read``
        / ``io_blocks`` here describe the serving stream alone."""
        with self._lock:
            total = self.hits + self.misses
            out = {
                "cache_hits": self.hits,
                "cache_misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "pinned_nodes": len(self._pinned),
                "cached_nodes": len(self._lru),
                "blocks_read": self.store.stats.blocks_read,
                "io_blocks": self.store.stats.io_blocks,
                "read_time_s": self.store.stats.read_time_s,
                "measured_read_us": self.store.stats.measured_read_us(),
            }
            if self._hot is not None:
                out.update(self._hot.stats())
            return out

    def fetch_latency_us(self) -> dict:
        """Percentiles over the recent per-call fetch wall times (bounded
        window).  Kept out of :meth:`stats` — that runs at every pipeline
        gather, and percentile math over 64k samples there would put numpy
        work on the host loop for numbers only benchmarks read."""
        with self._lock:
            arr = np.asarray(self._fetch_us, np.float64)
        if arr.size == 0:
            return {"fetch_p50_us": 0.0, "fetch_p99_us": 0.0,
                    "fetch_mean_us": 0.0, "fetch_samples": 0}
        return {"fetch_p50_us": float(np.percentile(arr, 50)),
                "fetch_p99_us": float(np.percentile(arr, 99)),
                "fetch_mean_us": float(arr.mean()),
                "fetch_samples": int(arr.size)}

    def reset_stats(self) -> None:
        """Zero the counters and the latency window.  Hot-tier *state*
        (residency, the frequency EMA) survives — it is policy memory, not
        a statistic."""
        with self._lock:
            self.hits = self.misses = 0
            self._fetch_us.clear()
            self.store.reset_stats()
            if self._hot is not None:
                self._hot.reset_stats()

    def clear_cache(self) -> None:
        """Empty the LRU (cold-cache experiments); the pinned set stays —
        it is static by design."""
        with self._lock:
            self._lru.clear()


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as host numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def entry_proximal_ids(adj, entry, limit: int = 256) -> np.ndarray:
    """BFS order from the entry medoid, truncated to ``limit`` nodes — the
    static pin set for the record cache (every query's walk starts here)."""
    adj = _host(adj)
    entry = int(_host(entry))
    seen = {entry}
    order = [entry]
    frontier = [entry]
    while frontier and len(order) < limit:
        nxt = []
        for u in frontier:
            for v in adj[u].tolist():
                if v >= 0 and v not in seen:
                    seen.add(v)
                    order.append(v)
                    nxt.append(v)
                    if len(order) >= limit:
                        return np.asarray(order, np.int64)
        frontier = nxt
    return np.asarray(order, np.int64)


def open_or_build_slow_tier(path, index: TieredIndex,
                            cache_nodes: int = 4096, pin_nodes: int = 256,
                            log=None, nodes_per_block: int = 1,
                            slot_of: np.ndarray | None = None,
                            io_workers: int | None = None,
                            hot_nodes: int = 0, hot_chunk: int = 256,
                            freq_decay: float = 0.5) -> BlockSlowTier:
    """The serving bootstrap of every ``--disk PATH`` consumer: open the
    block store for ``index``, or write it when it is absent, unreadable,
    stale or laid out differently
    (:func:`repro_torch.index.blockstore.ensure_block_store`), and wrap it
    in a :class:`BlockSlowTier` with the entry-proximal neighbourhood
    pinned.  ``nodes_per_block`` / ``slot_of`` select the packed layout
    (:func:`repro_torch.core.build.block_layout`); ``io_workers`` sizes the
    prefetch pool; ``hot_nodes`` / ``hot_chunk`` / ``freq_decay`` enable the
    hot tier.  The index's tensors are copied to the host once."""
    from repro_torch.index.blockstore import ensure_block_store

    adj = _host(index.graph.adj)
    store = ensure_block_store(path, _host(index.vectors), adj, log=log,
                               nodes_per_block=nodes_per_block,
                               slot_of=slot_of)
    pinned = (entry_proximal_ids(adj, index.graph.entry, limit=pin_nodes)
              if pin_nodes > 0 else None)
    return BlockSlowTier(store, cache_nodes=cache_nodes, pinned_ids=pinned,
                         io_workers=io_workers, hot_nodes=hot_nodes,
                         hot_chunk=hot_chunk, freq_decay=freq_decay)


def rerank_with_slow_tier(slow_tier, beam_ids, queries: torch.Tensor,
                          k: int, prefetched: np.ndarray | None = None):
    """Slow-tier rerank of a full beam through the pluggable tier.

    Fetches the beam's rows on the host (``prefetched``, the joined result
    of :meth:`BlockSlowTier.prefetch`, skips the fetch), copies the (Q, L,
    D) rows to the queries' device and runs the in-memory rerank's
    arithmetic on them (:func:`repro_torch.core.search._rerank_from_vecs`):
    the same values in the same contiguous layout through the same
    reduction, so the results are bit-identical to the in-memory rerank.
    """
    dev = queries.device
    vecs = (prefetched if prefetched is not None
            else slow_tier.fetch_beams(_host(beam_ids)))
    return search_mod._rerank_from_vecs(
        torch.as_tensor(beam_ids, device=dev),
        torch.from_numpy(np.ascontiguousarray(vecs)).to(dev), queries, k)
