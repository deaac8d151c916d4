"""Index (de)serialisation (port of :mod:`repro.index.serializer`).

A numpy ``.npz`` container with a JSON manifest, in the reference's two
formats, so each package loads the other's files:

* ``v1`` (``repro.tiered_index.v1``) — everything, slow-tier vectors
  included, in one npz (``version=1``, the default).
* ``v2`` (``repro.tiered_index.v2``) — the npz holds the fast tier only
  (graph, PQ codebook and codes, LID profile) and the manifest points at a
  sidecar block store (``<path>.blocks``,
  :mod:`repro_torch.index.blockstore`) holding each node's vector and
  adjacency in one checksummed aligned block.  :func:`load_index` reads the
  vectors back out of it; :func:`load_slow_tier` opens it as a live
  :class:`~repro_torch.index.disk.BlockSlowTier` instead.

The manifest's format strings are file-format identifiers shared with the
reference.  The arrays are written with the reference's dtypes (``adj``
int32, ``entry`` 0-d int32, ``alpha`` / ``lid`` float32, ``mu`` / ``sigma``
0-d float32, ``centroids`` float32, ``codes`` uint8, ``vectors`` float32).
The optional riders (``disk_model``, ``shard_laws``, ``lineage``) ride in
both formats.  ``.npz`` files carry zip timestamps, so only the ``.blocks``
sidecars are byte-stable.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

from repro_torch.index import blockstore
from repro_torch.index.convert import tiered_index_from_arrays
from repro_torch.index.disk import (BlockSlowTier, DiskTierModel,
                                    TieredIndex, _host, entry_proximal_ids)

FORMAT_V1 = "repro.tiered_index.v1"
FORMAT_V2 = "repro.tiered_index.v2"


def blocks_path(path: str | pathlib.Path) -> pathlib.Path:
    """The v2 sidecar block-store path for an index file."""
    path = pathlib.Path(path)
    return path.with_name(path.name + ".blocks")


def save_index(
    path: str | pathlib.Path,
    index: TieredIndex,
    disk_model: DiskTierModel | None = None,
    shard_laws=None,
    version: int = 1,
    nodes_per_block: int = 1,
    slot_of=None,
    lineage: dict | None = None,
) -> None:
    """Write one index (its tensors may live on any device).

    ``disk_model`` (the slow tier's latency model), ``shard_laws`` (a
    (lam (S,), l_min (S,)) pair of per-shard budget laws) and ``lineage``
    (a JSON-serialisable mutation history) ride in the manifest.
    ``version=2`` writes the fast tier to the npz and the slow tier to the
    ``<path>.blocks`` sidecar, laid out by ``nodes_per_block`` / ``slot_of``
    (:func:`repro_torch.core.build.block_layout`); the layout rides in the
    manifest's ``blocks`` entry so a reopened store is cross-checked.
    """
    if version not in (1, 2):
        raise ValueError(f"unknown index format version {version}")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    manifest = {
        "format": FORMAT_V1 if version == 1 else FORMAT_V2,
        "n": int(index.n),
        "degree": int(index.graph.degree_cap),
        "m_pq": int(index.codebook.m),
    }
    if disk_model is not None:
        manifest["disk_model"] = {
            "read_latency_us": float(disk_model.read_latency_us),
            "queue_depth": int(disk_model.queue_depth),
        }
    if shard_laws is not None:
        lam, l_min = shard_laws
        assert len(lam) == len(l_min), (len(lam), len(l_min))
        manifest["shard_laws"] = {
            "lam": [float(v) for v in _host(lam)],
            "l_min": [int(v) for v in _host(l_min)],
        }
    if lineage is not None:
        manifest["lineage"] = json.loads(json.dumps(lineage))  # must be JSON
    g = index.graph
    arrays = dict(
        adj=_host(g.adj).astype(np.int32, copy=False),
        entry=_host(g.entry).astype(np.int32, copy=False).reshape(()),
        alpha=_host(g.alpha).astype(np.float32, copy=False),
        lid=_host(g.lid).astype(np.float32, copy=False),
        mu=_host(g.mu).astype(np.float32, copy=False).reshape(()),
        sigma=_host(g.sigma).astype(np.float32, copy=False).reshape(()),
        centroids=_host(index.codebook.centroids).astype(np.float32,
                                                         copy=False),
        codes=_host(index.codes).astype(np.uint8, copy=False),
    )
    vectors = _host(index.vectors).astype(np.float32, copy=False)
    if version == 1:
        arrays["vectors"] = vectors
    else:
        bp = blockstore.write_block_store(
            blocks_path(path), vectors, arrays["adj"],
            nodes_per_block=nodes_per_block, slot_of=slot_of)
        store = blockstore.BlockStore(bp)
        manifest["blocks"] = {
            "file": bp.name,           # sibling of the npz, relocatable
            "block_size": store.block_size,
            "n": store.n, "d": store.d, "r": store.r,
            # Content fingerprint: geometry alone cannot tell two builds of
            # the same shape apart.
            "vectors_crc32": store.vectors_crc32,
        }
        if store.nodes_per_block != 1 or store.slot_of is not None:
            manifest["blocks"]["nodes_per_block"] = store.nodes_per_block
            manifest["blocks"]["layout"] = store.layout
            manifest["blocks"]["slot_table_crc32"] = store.slot_table_crc32
    np.savez_compressed(path, manifest=json.dumps(manifest), **arrays)


def _read_manifest(path: pathlib.Path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["manifest"]))


def load_disk_model(path: str | pathlib.Path) -> DiskTierModel | None:
    """The DiskTierModel stored with the index, or None."""
    dm = _read_manifest(pathlib.Path(path)).get("disk_model")
    if dm is None:
        return None
    return DiskTierModel(read_latency_us=float(dm["read_latency_us"]),
                         queue_depth=int(dm["queue_depth"]))


def load_shard_laws(path: str | pathlib.Path):
    """The per-shard (lam float32, l_min int32) budget-law arrays stored
    with the index, or None."""
    laws = _read_manifest(pathlib.Path(path)).get("shard_laws")
    if laws is None:
        return None
    return (np.asarray(laws["lam"], np.float32),
            np.asarray(laws["l_min"], np.int32))


def load_lineage(path: str | pathlib.Path) -> dict | None:
    """The mutation lineage stored with the index, or None."""
    return _read_manifest(pathlib.Path(path)).get("lineage")


def load_index(path: str | pathlib.Path, device="cuda") -> TieredIndex:
    """Load either format into a :class:`TieredIndex` on ``device``.

    v1 reads the vectors from the npz, v2 from the sidecar block store
    (every record CRC-checked): the same arrays either way.
    """
    path = pathlib.Path(path)
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        fmt = manifest.get("format")
        if fmt not in (FORMAT_V1, FORMAT_V2):
            raise ValueError(
                f"{path}: unknown index format {fmt!r} "
                f"(expected {FORMAT_V1} or {FORMAT_V2})")
        arrays = {k: z[k] for k in ("adj", "entry", "alpha", "lid", "mu",
                                    "sigma", "centroids", "codes")}
        if fmt == FORMAT_V1:
            arrays["vectors"] = z["vectors"]
    if fmt == FORMAT_V2:
        store = open_block_store(path, manifest=manifest)
        arrays["vectors"], _adj = store.read_many(np.arange(store.n))
    return tiered_index_from_arrays(arrays, device)


def open_block_store(path: str | pathlib.Path,
                     manifest: dict | None = None) -> blockstore.BlockStore:
    """Open a v2 index's sidecar block store, cross-checking the manifest's
    geometry, content fingerprint and layout against the store header (a
    stale or swapped sidecar is a format error)."""
    path = pathlib.Path(path)
    if manifest is None:
        manifest = _read_manifest(path)
    blk = manifest.get("blocks")
    if blk is None:
        raise blockstore.BlockStoreFormatError(
            f"{path}: index format {manifest.get('format')!r} has no block "
            "sidecar (saved with version=1?); re-save with "
            "save_index(..., version=2) to serve the slow tier from disk")
    store = blockstore.BlockStore(path.with_name(blk["file"]))
    keys = ("n", "d", "r", "block_size")
    if blk.get("vectors_crc32") is not None:
        keys += ("vectors_crc32",)   # content identity, not just geometry
    for key in ("nodes_per_block", "slot_table_crc32"):
        if blk.get(key) is not None:
            keys += (key,)           # layout rider (packed builds)
    for key in keys:
        sval = getattr(store, key)
        if sval is None or int(blk[key]) != int(sval):
            raise blockstore.BlockStoreFormatError(
                f"{store.path}: sidecar {key}={sval} does not match the "
                f"index manifest's {key}={blk[key]} (stale or swapped "
                "block file)")
    if blk.get("layout") is not None and blk["layout"] != store.layout:
        raise blockstore.BlockStoreFormatError(
            f"{store.path}: sidecar layout={store.layout!r} does not match "
            f"the index manifest's layout={blk['layout']!r} (stale or "
            "swapped block file)")
    return store


def load_slow_tier(path: str | pathlib.Path, cache_nodes: int = 4096,
                   pin_nodes: int = 256) -> BlockSlowTier:
    """Open a v2 index's sidecar as a live :class:`BlockSlowTier`, the
    entry-proximal nodes (BFS from the medoid over the npz adjacency)
    pinned.  Nothing slow-tier-sized is read into host memory."""
    path = pathlib.Path(path)
    store = open_block_store(path)
    pinned = None
    if pin_nodes > 0:
        with np.load(path, allow_pickle=False) as z:
            adj, entry = z["adj"], z["entry"]
        pinned = entry_proximal_ids(adj, entry, limit=pin_nodes)
    return BlockSlowTier(store, cache_nodes=cache_nodes, pinned_ids=pinned)
