"""Block-aligned on-disk node store: the disk slow tier's storage format
(port of :mod:`repro.index.blockstore`; numpy only, no torch).

One node's full-precision vector and its adjacency list live in the same
aligned disk block, so a beam expansion (or a rerank fetch) is exactly one
block read:

    block 0      : header — magic + JSON manifest, zero padded
    blocks 1 .. T: slot table — node id -> record slot, ``<i4``, zero
                   padded (T = 0 for the node-order layout)
    block 1+T+s  : the record of node ``node_of[s]`` —
                   [vector f32 (D,)] [adj i32 (R,)] [crc32 u32],
                   zero padded to ``block_size``

``block_size`` is the record payload rounded up to a multiple of
:data:`SECTOR` (512 B).  All fields are little-endian, and the file is
byte-identical to the one the reference writes for the same vectors,
adjacency, ``nodes_per_block`` and ``slot_of`` (header JSON key order
included), so each package opens the other's stores: :data:`MAGIC` and
:data:`FORMAT` are file-format identifiers.  Reads go through one shared
``np.memmap``; pages fault in on first touch, so a store that was just
written is read from the OS page cache.

``nodes_per_block`` groups that many consecutive record slots into one I/O
block, the unit a packed layout co-locates (:func:`repro_torch.core.prune
.greedy_block_pack`); :attr:`BlockReadStats.io_blocks` counts distinct I/O
blocks touched.  Default-layout files (``nodes_per_block=1``, no
permutation) carry none of the layout keys in their manifest.

Every record carries a CRC32 over its payload: a torn write, bit rot or a
wrong-length file surfaces as a typed error (:class:`BlockChecksumError`,
:class:`BlockStoreTruncatedError`, :class:`BlockStoreFormatError`) instead
of wrong neighbours.  The serving cache and prefetch policy live in
:class:`repro_torch.index.disk.BlockSlowTier`.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
import zlib

import numpy as np

MAGIC = b"MCGIBLK2"
FORMAT = "repro.blockstore.v2"
SECTOR = 512


class BlockStoreError(Exception):
    """Base class for slow-tier storage faults."""


class BlockStoreFormatError(BlockStoreError):
    """Bad magic / unknown format / manifest inconsistent with the file."""


class BlockStoreTruncatedError(BlockStoreError):
    """File shorter than the manifest's node count implies."""


class BlockChecksumError(BlockStoreError):
    """A node record's payload fails its CRC32 (torn write / bit rot)."""


def block_size_for(d: int, r: int) -> int:
    """Record bytes (vector + adjacency + crc) rounded up to a sector."""
    payload = d * 4 + r * 4 + 4
    return ((payload + SECTOR - 1) // SECTOR) * SECTOR


def vectors_crc32(vectors: np.ndarray) -> int:
    """Content fingerprint of a slow tier (little-endian f32 bytes).

    Written into the store manifest and cross-checked by consumers that
    already hold the vectors (or, for v2 indexes, recorded in the npz
    manifest): geometry alone — (n, d, r) — cannot tell two builds of the
    same shape apart, and a stale store with matching shape would otherwise
    serve wrong reranks silently.
    """
    arr = np.ascontiguousarray(np.asarray(vectors), dtype="<f4")
    return zlib.crc32(arr)   # buffer protocol: no store-sized copy


@dataclasses.dataclass
class BlockReadStats:
    """Cumulative reader counters (reset with :meth:`BlockStore.reset_stats`).

    ``read_time_s`` is host wall time spent inside block reads — the
    *measured* counterpart of ``DiskTierModel.read_latency_us * blocks_read``.
    ``io_blocks`` counts distinct I/O blocks (``nodes_per_block`` record
    slots each) touched per read call — equal to ``blocks_read`` for the
    default one-record-per-block layout, strictly smaller when a packed
    layout makes co-expanded records share a block.
    """

    blocks_read: int = 0
    read_time_s: float = 0.0
    io_blocks: int = 0

    def measured_read_us(self) -> float:
        """Mean measured latency per block read, in microseconds."""
        if self.blocks_read == 0:
            return 0.0
        return self.read_time_s * 1e6 / self.blocks_read


class BlockStore:
    """Reader over one block file (see the module docstring for the layout).

    Open is cheap (header block only); node reads are memmap slices, each
    CRC-verified.  ``read_many`` is the serving entry point: it returns the
    (n, D) vectors and (n, R) adjacency for a batch of node ids and counts
    every record touched in :attr:`stats`.
    """

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        try:
            raw = np.memmap(self.path, dtype=np.uint8, mode="r")
        except (FileNotFoundError, ValueError) as e:
            raise BlockStoreFormatError(
                f"cannot open block store {self.path}: {e}") from e
        if raw.size < SECTOR or bytes(raw[: len(MAGIC)]) != MAGIC:
            raise BlockStoreFormatError(
                f"{self.path}: not a block store (bad magic)")
        hlen = int(raw[len(MAGIC): len(MAGIC) + 4].view("<u4")[0])
        if hlen <= 0 or len(MAGIC) + 4 + hlen > raw.size:
            raise BlockStoreFormatError(
                f"{self.path}: header length {hlen} exceeds the file")
        try:
            manifest = json.loads(
                bytes(raw[len(MAGIC) + 4: len(MAGIC) + 4 + hlen]))
        except json.JSONDecodeError as e:
            raise BlockStoreFormatError(
                f"{self.path}: unreadable manifest: {e}") from e
        if manifest.get("format") != FORMAT:
            raise BlockStoreFormatError(
                f"{self.path}: format {manifest.get('format')!r}, "
                f"expected {FORMAT!r}")
        self.n = int(manifest["n"])
        self.d = int(manifest["d"])
        self.r = int(manifest["r"])
        self.block_size = int(manifest["block_size"])
        # Content fingerprint (absent only in stores from before it existed).
        v = manifest.get("vectors_crc32")
        self.vectors_crc32 = None if v is None else int(v)
        if self.block_size < block_size_for(self.d, self.r):
            raise BlockStoreFormatError(
                f"{self.path}: block_size {self.block_size} cannot hold a "
                f"(d={self.d}, r={self.r}) record")
        if self.block_size > raw.size:  # header block itself must fit
            raise BlockStoreTruncatedError(
                f"{self.path}: file smaller than one block")
        # Layout rider (absent -> the historical one-record-per-block file).
        self.nodes_per_block = int(manifest.get("nodes_per_block", 1))
        self.layout = manifest.get("layout", "node-order")
        table_blocks = int(manifest.get("slot_table_blocks", 0))
        if self.nodes_per_block < 1:
            raise BlockStoreFormatError(
                f"{self.path}: nodes_per_block {self.nodes_per_block} < 1")
        self._data_start = 1 + table_blocks
        expect = (self._data_start + self.n) * self.block_size
        if raw.size < expect:
            raise BlockStoreTruncatedError(
                f"{self.path}: {raw.size} bytes on disk, manifest needs "
                f"{expect} ({self.n} nodes x {self.block_size}B + header)")
        self._mm = raw
        if table_blocks:
            tbl = raw[self.block_size: self.block_size * self._data_start]
            slot_of = tbl[: self.n * 4].view("<i4").astype(np.int64)
            crc = manifest.get("slot_table_crc32")
            if crc is not None and zlib.crc32(
                    np.ascontiguousarray(slot_of.astype("<i4"))) != int(crc):
                raise BlockStoreFormatError(
                    f"{self.path}: slot table fails its CRC32")
            if not np.array_equal(np.sort(slot_of), np.arange(self.n)):
                raise BlockStoreFormatError(
                    f"{self.path}: slot table is not a permutation")
            self.slot_of = slot_of
            self.node_of = np.empty_like(slot_of)
            self.node_of[slot_of] = np.arange(self.n, dtype=np.int64)
        else:
            self.slot_of = None   # identity layout
            self.node_of = None
        self.stats = BlockReadStats()

    def reset_stats(self) -> None:
        self.stats = BlockReadStats()

    @property
    def slot_table_crc32(self) -> int | None:
        """CRC32 of the persisted ``<i4`` slot table (None for identity)."""
        if self.slot_of is None:
            return None
        return zlib.crc32(np.ascontiguousarray(self.slot_of.astype("<i4")))

    # ------------------------------------------------------------- reading

    def io_block_of(self, ids: np.ndarray) -> np.ndarray:
        """The I/O block index holding each node's record."""
        ids = np.asarray(ids, dtype=np.int64)
        slots = ids if self.slot_of is None else self.slot_of[ids]
        return slots // self.nodes_per_block

    def _check_range(self, ids: np.ndarray) -> None:
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise IndexError(
                f"node id out of range [0, {self.n}): "
                f"{ids[(ids < 0) | (ids >= self.n)][0]}")

    def _records_at(self, slots: np.ndarray,
                    named: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """CRC-checked record payloads at ``slots``; ``named`` are the node
        ids to blame in checksum errors."""
        bs, d, r = self.block_size, self.d, self.r
        payload = d * 4 + r * 4
        # One fancy-indexed gather over the block-matrix view: rows fault in
        # via the page cache exactly like queue_depth concurrent block reads.
        blocks = self._mm[: (self._data_start + self.n) * bs].reshape(
            self._data_start + self.n, bs)
        recs = np.ascontiguousarray(
            blocks[self._data_start + slots, : payload + 4])
        stored = recs[:, payload: payload + 4].view("<u4").ravel()
        for row, i in enumerate(named):
            # crc32 over the contiguous row view: no per-record copy on the
            # hot read path (this time is part of the measured read latency).
            if zlib.crc32(recs[row, :payload]) != int(stored[row]):
                raise BlockChecksumError(
                    f"{self.path}: node {int(i)} payload fails CRC32 "
                    "(torn write or bit rot)")
        vecs = recs[:, : d * 4].view("<f4").reshape(-1, d)
        adj = recs[:, d * 4: payload].view("<i4").reshape(-1, r)
        return vecs, adj

    def read_many(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Read the records of ``ids`` (1-D int array, each in [0, n)).

        Returns (vectors (len, D) f32, adj (len, R) i32); raises
        :class:`BlockChecksumError` naming the first corrupt node.  Each id
        in the argument counts as one block read (callers dedupe — the
        cache layer above does).
        """
        ids = np.asarray(ids, dtype=np.int64)
        self._check_range(ids)
        t0 = time.perf_counter()
        slots = ids if self.slot_of is None else self.slot_of[ids]
        vecs, adj = self._records_at(slots, ids)
        self.stats.blocks_read += int(ids.size)
        self.stats.io_blocks += int(
            np.unique(slots // self.nodes_per_block).size)
        self.stats.read_time_s += time.perf_counter() - t0
        return vecs, adj

    def read_blocks(
        self, block_ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched multi-block fetch: every record of the given I/O blocks.

        The walk-time read path — a miss on one node pulls its whole I/O
        block so the cache layer can keep all co-located records (that is
        the whole point of the packed layout).  Returns
        ``(node_ids, vectors, adj)`` for every record slot covered, in slot
        order.  Counts one ``io_blocks`` per distinct block and one
        ``blocks_read`` per record returned.
        """
        block_ids = np.unique(np.asarray(block_ids, dtype=np.int64))
        npb = self.nodes_per_block
        n_blocks = (self.n + npb - 1) // npb
        if block_ids.size and (block_ids.min() < 0
                               or block_ids.max() >= n_blocks):
            raise IndexError(
                f"I/O block out of range [0, {n_blocks}): "
                f"{block_ids[(block_ids < 0) | (block_ids >= n_blocks)][0]}")
        t0 = time.perf_counter()
        slots = (block_ids[:, None] * npb + np.arange(npb)).ravel()
        slots = slots[slots < self.n]
        node_ids = slots if self.node_of is None else self.node_of[slots]
        vecs, adj = self._records_at(slots, node_ids)
        self.stats.blocks_read += int(slots.size)
        self.stats.io_blocks += int(block_ids.size)
        self.stats.read_time_s += time.perf_counter() - t0
        return node_ids, vecs, adj

def write_block_store(
    path: str | pathlib.Path,
    vectors: np.ndarray,
    adj: np.ndarray,
    block_size: int | None = None,
    nodes_per_block: int = 1,
    slot_of: np.ndarray | None = None,
) -> pathlib.Path:
    """Write a block store for (vectors (N, D) f32, adj (N, R) i32).

    ``block_size`` defaults to the tight sector-aligned record size; a larger
    multiple of :data:`SECTOR` is accepted (e.g. to pin 4K pages).

    ``nodes_per_block`` sets the I/O-block granularity (how many record
    slots one device read covers); ``slot_of`` (an (N,) permutation,
    node id -> record slot, e.g. from
    :func:`repro_torch.core.prune.greedy_block_pack`)
    packs co-expanded neighbours into shared I/O blocks.  The default
    ``(1, None)`` writes the historical byte-exact format with none of the
    layout keys.
    """
    path = pathlib.Path(path)
    vectors = np.ascontiguousarray(np.asarray(vectors), dtype="<f4")
    adj = np.ascontiguousarray(np.asarray(adj), dtype="<i4")
    assert vectors.ndim == 2 and adj.ndim == 2, (vectors.shape, adj.shape)
    assert vectors.shape[0] == adj.shape[0], (vectors.shape, adj.shape)
    n, d = vectors.shape
    r = adj.shape[1]
    tight = block_size_for(d, r)
    if block_size is None:
        block_size = tight
    if block_size < tight or block_size % SECTOR:
        raise ValueError(
            f"block_size {block_size} must be a sector multiple >= {tight}")
    if nodes_per_block < 1:
        raise ValueError(f"nodes_per_block {nodes_per_block} must be >= 1")
    manifest_fields = {
        "format": FORMAT, "n": n, "d": d, "r": r, "block_size": block_size,
        "checksum": "crc32", "vectors_crc32": zlib.crc32(vectors),
    }
    table_blocks = 0
    if slot_of is not None:
        slot_of = np.ascontiguousarray(np.asarray(slot_of), dtype="<i4")
        if not np.array_equal(np.sort(slot_of.astype(np.int64)),
                              np.arange(n)):
            raise ValueError("slot_of must be a permutation of [0, n)")
        table_blocks = (n * 4 + block_size - 1) // block_size
    if slot_of is not None or nodes_per_block > 1:
        manifest_fields.update(
            nodes_per_block=nodes_per_block,
            layout="packed" if slot_of is not None else "node-order",
            slot_table_blocks=table_blocks)
        if slot_of is not None:
            manifest_fields["slot_table_crc32"] = zlib.crc32(slot_of)
    manifest = json.dumps(manifest_fields).encode()
    if len(MAGIC) + 4 + len(manifest) > block_size:
        raise ValueError("manifest does not fit the header block")
    payload = d * 4 + r * 4
    data_start = 1 + table_blocks
    blocks = np.zeros((data_start + n, block_size), dtype=np.uint8)
    blocks[0, : len(MAGIC)] = np.frombuffer(MAGIC, np.uint8)
    blocks[0, len(MAGIC): len(MAGIC) + 4] = np.frombuffer(
        np.uint32(len(manifest)).astype("<u4").tobytes(), np.uint8)
    blocks[0, len(MAGIC) + 4: len(MAGIC) + 4 + len(manifest)] = (
        np.frombuffer(manifest, np.uint8))
    if table_blocks:
        blocks[1:data_start].reshape(-1)[: n * 4] = slot_of.view(np.uint8)
        # Records land at their assigned slots: row `data_start + slot_of[i]`
        # holds node i.  node_order[s] = the node stored at slot s.
        node_order = np.empty((n,), dtype=np.int64)
        node_order[slot_of.astype(np.int64)] = np.arange(n)
    else:
        node_order = np.arange(n)
    blocks[data_start:, : d * 4] = (
        vectors[node_order].view(np.uint8).reshape(n, d * 4))
    blocks[data_start:, d * 4: payload] = (
        adj[node_order].view(np.uint8).reshape(n, r * 4))
    crcs = np.empty((n,), dtype="<u4")
    rows = blocks[data_start:, :payload]
    for i in range(n):
        crcs[i] = zlib.crc32(rows[i])   # contiguous row view, no copy
    blocks[data_start:, payload: payload + 4] = crcs.view(np.uint8).reshape(
        n, 4)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        blocks.tofile(f)   # no tobytes() double-copy of a store-sized buffer
    tmp.replace(path)  # atomic publish: no half-written store under readers
    return path


def ensure_block_store(
    path: str | pathlib.Path,
    vectors: np.ndarray,
    adj: np.ndarray,
    log=None,
    nodes_per_block: int = 1,
    slot_of: np.ndarray | None = None,
) -> BlockStore:
    """Open the store at ``path`` if its content fingerprint matches
    ``vectors`` (and its layout matches the requested one); otherwise —
    absent, unreadable (any :class:`BlockStoreError`), stale, or laid out
    differently — write it fresh and open that.

    The one bootstrap every consumer shares (serve launcher, e2e example,
    benchmarks): geometry can collide between two builds, a torn file must
    not crash the "rewrite if needed" promise, and the fingerprint is the
    only content identity.  ``log`` (e.g. ``print``) narrates what happened.
    """
    path = pathlib.Path(path)
    vectors = np.ascontiguousarray(np.asarray(vectors), dtype="<f4")
    want_table_crc = (
        None if slot_of is None
        else zlib.crc32(np.ascontiguousarray(np.asarray(slot_of), "<i4")))
    if path.exists():
        try:
            store = BlockStore(path)
            if store.vectors_crc32 != zlib.crc32(vectors):
                reason = "stale (content fingerprint mismatch)"
            elif (store.nodes_per_block != nodes_per_block
                  or store.slot_table_crc32 != want_table_crc):
                reason = "laid out differently"
            else:
                return store
        except BlockStoreError as e:
            reason = f"unreadable ({type(e).__name__})"
        if log:
            log(f"block store {path} is {reason}; rewriting")
    write_block_store(path, vectors, adj, nodes_per_block=nodes_per_block,
                      slot_of=slot_of)
    if log:
        log(f"wrote block store {path} ({path.stat().st_size/1e6:.1f}MB)")
    return BlockStore(path)
