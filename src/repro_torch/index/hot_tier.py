"""Frequency-aware hot tier: chunked asynchronous promotion and demotion
of graph nodes above a :class:`repro_torch.index.disk.BlockSlowTier`'s
LRU (port of :mod:`repro.index.hot_tier`; numpy on the host).

* **per-node EMA frequency** — every tier fetch adds 1 to each distinct
  accessed id (``freq[id] += 1``); every promotion tick multiplies the whole
  array by ``decay``, so old traffic ages out and a shifted hot set
  overtakes the old one.
* **dense hot storage** — promoted records live in preallocated arrays
  (``vectors (capacity, D)``, ``adj (capacity, R)``) with O(1) membership
  (``slot[id]``, -1 when absent), probed on the tier's fetch path between
  the pinned set and the LRU.
* **chunked asynchronous promotion** — :meth:`HotTier.submit_tick` runs one
  tick on the tier's own single-thread promoter: snapshot and decay the
  frequencies, pick up to ``chunk`` hottest non-resident nodes, read their
  records through a private
  :class:`~repro_torch.index.blockstore.BlockStore` handle (promotion I/O
  shares neither the serving I/O lock nor the serving counters), and
  install them under the shared cache lock.  Demotion is metadata only:
  records are immutable, so the hot tier changes where a record is read
  from, never its bytes.
* **hysteresis** — a resident is demoted only for a strictly hotter
  candidate, so ties never thrash; statically pinned ids are never
  promoted.

Device mirror (``device_mirror=True``): after each tick the hot arrays are
copied to torch tensors on ``mirror_device`` (``device_vectors`` /
``device_adj`` / ``device_node_of``), a synchronous copy made on the
promoter thread.  Off by default, as in the reference: nothing on the
serving path reads the mirror yet.
"""
from __future__ import annotations

import concurrent.futures
import threading

import numpy as np

from repro_torch.index.blockstore import BlockStore


class HotTier:
    """Frequency-tracked fast tier above a :class:`BlockSlowTier`'s LRU.

    Owned by the tier: shares its cache lock (``lock``), probes on its fetch
    path, and is ticked via :meth:`submit_tick` from the serving engine's
    gather stage.  All mutation of residency (``slot`` / ``node_of`` / the
    record arrays) happens on the single promoter thread, under the shared
    lock only for the install memcpy — so fetches either see the old
    location (LRU/miss) or the new one (hot), both serving identical bytes.
    """

    def __init__(self, store: BlockStore, n: int, capacity: int, *,
                 chunk: int = 256, decay: float = 0.5,
                 lock: threading.Lock, exclude_ids=None,
                 device_mirror: bool = False, mirror_device="cuda"):
        self.store = store              # private handle: promotion I/O only
        self.capacity = int(capacity)
        self.chunk = max(1, int(chunk))
        self.decay = float(decay)
        self._lock = lock               # shared with the owning BlockSlowTier
        self.device_mirror = bool(device_mirror)
        self.mirror_device = mirror_device
        # Per-node EMA access frequency (written under the shared lock by
        # the tier's fetch path; snapshotted + decayed at each tick).
        self.freq = np.zeros(n, np.float32)
        # Membership: node id -> hot slot (-1 absent) and the inverse map.
        self.slot = np.full(n, -1, np.int32)
        self.node_of = np.full(self.capacity, -1, np.int64)
        self.vectors = np.zeros((self.capacity, store.d), np.float32)
        self.adj = np.full((self.capacity, store.r), -1, np.int32)
        self._excluded = (np.unique(np.asarray(exclude_ids, np.int64))
                          if exclude_ids is not None else
                          np.empty(0, np.int64))
        self.n_hot = 0
        self.hot_hits = 0
        self.promotions = 0
        self.demotions = 0
        self.ticks = 0
        self.device_vectors = None
        self.device_adj = None
        self.device_node_of = None
        self._pool = None               # lazy: tiers that never tick stay free
        self._closed = False

    # ------------------------------------------------------------- lifecycle

    def submit_tick(self) -> "concurrent.futures.Future":
        """Enqueue one promotion tick on the promoter thread (the caller —
        :meth:`BlockSlowTier.promotion_tick` — holds the shared lock and has
        already checked there is no tick in flight)."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hot-tier-promoter")
        return self._pool.submit(self._tick)

    def close(self, wait: bool = True) -> None:
        """Shut down the promoter thread (idempotent); a tick in flight
        completes first when ``wait``.  Residency stays probe-able — only
        future ticks are refused."""
        pool, self._pool = self._pool, None
        self._closed = True
        if pool is not None:
            pool.shutdown(wait=wait)

    # ------------------------------------------------------------- the tick

    def _tick(self) -> int:
        """One promotion round; returns the number of nodes promoted.

        Runs entirely on the promoter thread.  ``slot`` / ``node_of`` are
        only ever written here, so the selection below reads them without
        the lock; the lock guards just the frequency snapshot+decay and the
        final install memcpy.
        """
        with self._lock:
            snap = self.freq.copy()
            self.freq *= self.decay
            self.ticks += 1
        if self._excluded.size:
            snap[self._excluded] = 0.0
        n = snap.shape[0]
        cap = self.capacity
        # Hottest `cap` candidates with nonzero score, hottest first.
        if n > cap:
            top = np.argpartition(-snap, cap - 1)[:cap]
        else:
            top = np.arange(n)
        top = top[snap[top] > 0.0]
        top = top[np.argsort(-snap[top], kind="stable")]
        cand = top[self.slot[top] < 0][:self.chunk].astype(np.int64)
        if cand.size == 0:
            return 0
        free_slots = np.nonzero(self.node_of < 0)[0]
        n_free = min(free_slots.size, cand.size)
        victim_slots = np.empty(0, np.int64)
        need = cand.size - n_free
        if need > 0:
            resident = np.nonzero(self.node_of >= 0)[0]
            coldest = resident[np.argsort(snap[self.node_of[resident]],
                                          kind="stable")][:need]
            extra = cand[n_free:]
            # Hysteresis: pair the hottest extras with the coldest
            # residents; keep a pair only if strictly hotter.  Both sides
            # are sorted, so `keep` is a true prefix.
            keep = snap[extra] > snap[self.node_of[coldest]]
            k = int(keep.size if keep.all() else keep.argmin())
            victim_slots = coldest[:k].astype(np.int64)
            cand = np.concatenate([cand[:n_free], extra[:k]])
        if cand.size == 0:
            return 0
        slots = np.concatenate(
            [free_slots[:n_free].astype(np.int64), victim_slots])
        # Promotion I/O on the private store handle — off the serving path.
        vecs, adjs = self.store.read_many(cand)
        with self._lock:
            old = self.node_of[slots]
            demoted = old[old >= 0]
            if demoted.size:
                self.slot[demoted] = -1
            self.vectors[slots] = vecs
            self.adj[slots] = adjs
            self.node_of[slots] = cand
            self.slot[cand] = slots
            self.n_hot += int(cand.size) - int(demoted.size)
            self.promotions += int(cand.size)
            self.demotions += int(demoted.size)
        if self.device_mirror:
            self._upload()
        return int(cand.size)

    def _upload(self) -> None:
        """Refresh the device mirror of the hot arrays: torch tensors on
        ``mirror_device``, copied synchronously on the promoter thread."""
        import torch

        from repro_torch import resolve_device

        dev = resolve_device(self.mirror_device)
        with self._lock:
            v, a, ids = (self.vectors.copy(), self.adj.copy(),
                         self.node_of.copy())
        self.device_vectors = torch.from_numpy(v).to(dev)
        self.device_adj = torch.from_numpy(a).to(dev)
        self.device_node_of = torch.from_numpy(ids).to(dev)

    # ---------------------------------------------------------- observability

    def stats(self) -> dict:
        """Promotion counters (caller holds the shared lock — this is read
        from :meth:`BlockSlowTier.stats` at every pipeline gather).
        Promotion I/O is reported from the private store handle, so it never
        pollutes the serving stream's ``blocks_read`` / ``io_blocks``."""
        return {
            "hot_capacity": self.capacity,
            "hot_nodes": self.n_hot,
            "hot_hits": self.hot_hits,
            "promotions": self.promotions,
            "demotions": self.demotions,
            "promotion_ticks": self.ticks,
            "promotion_io_blocks": self.store.stats.io_blocks,
            "promotion_read_time_s": self.store.stats.read_time_s,
        }

    def reset_stats(self) -> None:
        """Zero the counters (caller holds the shared lock).  Residency and
        the frequency EMA are *state*, not stats — they survive."""
        self.hot_hits = self.promotions = self.demotions = self.ticks = 0
        self.store.reset_stats()
