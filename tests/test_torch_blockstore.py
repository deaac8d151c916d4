"""The port's block store and block layout against the reference's.

* ``write_block_store`` writes the reference's bytes exactly (header JSON,
  slot table, records, CRCs), in node order and packed at
  ``nodes_per_block`` 4 and 8 with ``slot_of`` from ``greedy_block_pack``.
* Each package's ``BlockStore`` reads the other's file: equal arrays, equal
  ``blocks_read`` / ``io_blocks``.
* Every fault (truncation, bit rot, bad magic, wrong format, a torn slot
  table, a stale or re-laid-out store) raises the port's own typed error of
  the reference's class name, with the reference's message.
* ``greedy_block_pack``, ``block_layout`` and ``entry_proximal_ids`` equal
  the reference's on a graph the reference built and on random adjacency.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.core import build as jbuild  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro.data import make_dataset  # noqa: E402
from repro.index import blockstore as jbs  # noqa: E402
from repro.index import disk as jdisk  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.index import blockstore as tbs  # noqa: E402
from repro_torch.index import convert  # noqa: E402
from repro_torch.index import disk as tdisk  # noqa: E402
from tests._hypothesis_compat import given, settings, st  # noqa: E402

torch.set_num_threads(1)
N, D, R = 300, 24, 10
LAYOUTS = {"node-order": (1, False), "npb4-packed": (4, True),
           "npb8-packed": (8, True), "npb4-node-order": (4, False)}


def _data(seed=0, n=N, d=D, r=R):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(-1, n, size=(n, r)).astype(np.int32))


def _layout(adj, name):
    npb, packed = LAYOUTS[name]
    slot_of = None
    if packed:
        slot_of = jprune.greedy_block_pack(adj, 0, npb)
        np.testing.assert_array_equal(
            tprune.greedy_block_pack(adj, 0, npb), slot_of)
    return npb, slot_of


@pytest.fixture(scope="module")
def ref_graph():
    """An MCGI graph the reference built (tiny-uniform, D = 32, R = 12)."""
    x, _ = make_dataset("tiny-uniform", seed=0)
    x = x[:800]
    cfg = jbuild.BuildConfig(degree=12, beam_width=24, iters=1, batch=200,
                             max_hops=48)
    return np.asarray(x), jbuild.build_mcgi(x, cfg)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_store_bytes_identical_to_reference(tmp_path, layout):
    vectors, adj = _data(1)
    npb, slot_of = _layout(adj, layout)
    a = jbs.write_block_store(tmp_path / "ref.blocks", vectors, adj,
                              nodes_per_block=npb, slot_of=slot_of)
    b = tbs.write_block_store(tmp_path / "port.blocks", vectors, adj,
                              nodes_per_block=npb, slot_of=slot_of)
    assert a.read_bytes() == b.read_bytes()
    assert tbs.vectors_crc32(vectors) == jbs.vectors_crc32(vectors)


@pytest.mark.parametrize("block_size", [None, 1024, 4096])
def test_store_bytes_identical_at_any_block_size(tmp_path, block_size):
    vectors, adj = _data(2, d=16, r=8)
    a = jbs.write_block_store(tmp_path / "ref.blocks", vectors, adj,
                              block_size=block_size)
    b = tbs.write_block_store(tmp_path / "port.blocks", vectors, adj,
                              block_size=block_size)
    assert a.read_bytes() == b.read_bytes()
    assert tbs.block_size_for(16, 8) == jbs.block_size_for(16, 8)
    with pytest.raises(ValueError, match="sector multiple"):
        tbs.write_block_store(tmp_path / "bad.blocks", vectors, adj,
                              block_size=100)


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("layout", ["node-order", "npb8-packed"])
def test_each_package_reads_the_others_store(tmp_path, writer, layout):
    vectors, adj = _data(3)
    npb, slot_of = _layout(adj, layout)
    mod = jbs if writer == "ref" else tbs
    p = mod.write_block_store(tmp_path / "s.blocks", vectors, adj,
                              nodes_per_block=npb, slot_of=slot_of)
    js, ts = jbs.BlockStore(p), tbs.BlockStore(p)
    for attr in ("n", "d", "r", "block_size", "nodes_per_block", "layout",
                 "vectors_crc32", "slot_table_crc32"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    if slot_of is not None:
        np.testing.assert_array_equal(ts.slot_of, js.slot_of)
        np.testing.assert_array_equal(ts.node_of, js.node_of)
    ids = np.asarray([0, 9, 299, 9, 150, 7])
    got_many = ts.read_many(ids)
    for got, want in zip(got_many, js.read_many(ids)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_many[0], vectors[ids])
    blocks = np.asarray([0, 3, 3, (N - 1) // npb])
    for got, want in zip(ts.read_blocks(blocks), js.read_blocks(blocks)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts.io_block_of(ids), js.io_block_of(ids))
    assert (ts.stats.blocks_read, ts.stats.io_blocks) == (
        js.stats.blocks_read, js.stats.io_blocks)
    with pytest.raises(IndexError):
        ts.read_many(np.asarray([N]))
    with pytest.raises(IndexError):
        ts.read_blocks(np.asarray([N]))


def _truncate(p, store):
    p.write_bytes(p.read_bytes()[:-tbs.SECTOR])


def _flip_payload(p, store):
    raw = bytearray(p.read_bytes())
    raw[(1 + 7) * store.block_size + 2] ^= 0xFF          # node 7's vector
    p.write_bytes(bytes(raw))


def _bad_magic(p, store):
    raw = bytearray(p.read_bytes())
    raw[0] ^= 0xFF
    p.write_bytes(bytes(raw))


def _wrong_format(p, store):
    raw = bytearray(p.read_bytes())
    manifest = json.dumps({"format": "repro.blockstore.v999", "n": N,
                           "d": D, "r": R,
                           "block_size": store.block_size}).encode()
    raw[len(tbs.MAGIC): len(tbs.MAGIC) + 4] = (
        np.uint32(len(manifest)).astype("<u4").tobytes())
    end = len(tbs.MAGIC) + 4 + len(manifest)
    raw[len(tbs.MAGIC) + 4: end] = manifest
    raw[end: store.block_size] = b"\0" * (store.block_size - end)
    p.write_bytes(bytes(raw))


def _noise(p, store):
    p.write_bytes(b"\x01" * 2048)


def _missing(p, store):
    p.unlink()


def _torn_slot_table(p, store):
    raw = bytearray(p.read_bytes())
    raw[store.block_size + 4] ^= 0x01                      # node 1's slot
    p.write_bytes(bytes(raw))


def _huge_header(p, store):
    raw = bytearray(p.read_bytes())
    raw[len(tbs.MAGIC): len(tbs.MAGIC) + 4] = (
        np.uint32(1 << 30).astype("<u4").tobytes())
    p.write_bytes(bytes(raw))


FAULTS = {"truncated": (_truncate, False), "bit-rot": (_flip_payload, False),
          "bad-magic": (_bad_magic, False),
          "wrong-format": (_wrong_format, False), "noise": (_noise, False),
          "missing": (_missing, False),
          "torn-slot-table": (_torn_slot_table, True),
          "header-past-the-file": (_huge_header, False)}


def _raised(mod, p):
    """The error opening ``p`` and reading nodes 3, 7, 11 raises."""
    try:
        mod.BlockStore(p).read_many(np.asarray([3, 7, 11]))
    except Exception as e:      # noqa: BLE001 — the class is compared
        return e
    return None


@pytest.mark.parametrize("fault", list(FAULTS))
def test_typed_errors_match_the_reference(tmp_path, fault):
    damage, packed = FAULTS[fault]
    vectors, adj = _data(4)
    slot_of = np.random.default_rng(0).permutation(N) if packed else None
    p = tbs.write_block_store(tmp_path / "f.blocks", vectors, adj,
                              nodes_per_block=4 if packed else 1,
                              slot_of=slot_of)
    damage(p, tbs.BlockStore(p))
    want, got = _raised(jbs, p), _raised(tbs, p)
    assert want is not None and got is not None
    assert type(got).__name__ == type(want).__name__
    assert type(got).__module__ == "repro_torch.index.blockstore"
    assert isinstance(got, tbs.BlockStoreError)
    assert str(got) == str(want)
    if fault == "bit-rot":
        assert "node 7" in str(got)
        tbs.BlockStore(p).read_many(np.asarray([3, 11]))   # others still read


def test_stale_sidecar_is_a_format_error(tmp_path):
    """A v2 index whose sidecar was swapped (other geometry, or the same
    geometry with other content) is refused by both packages alike."""
    from repro.index import serializer as jser
    from repro_torch.index import serializer as tser

    vectors, adj = _data(5)
    rng = np.random.default_rng(5)
    index = convert.tiered_index_from_arrays(dict(
        adj=adj, entry=np.int32(0), alpha=np.ones(N, np.float32),
        lid=np.zeros(N, np.float32), mu=np.float32(0), sigma=np.float32(0),
        centroids=rng.normal(size=(4, 16, 6)).astype(np.float32),
        codes=rng.integers(0, 16, (N, 4)).astype(np.uint8),
        vectors=vectors), "cpu")
    p = tmp_path / "idx.npz"
    tser.save_index(p, index, version=2)
    sidecar = tser.blocks_path(p)
    for replace in (lambda: tbs.write_block_store(
                        sidecar, rng.normal(size=(10, 4)).astype(np.float32),
                        np.zeros((10, 2), np.int32)),
                    lambda: tbs.write_block_store(sidecar, vectors + 1.0,
                                                  adj)):
        replace()
        errs = []
        for mod, base in ((jser, jbs), (tser, tbs)):
            with pytest.raises(base.BlockStoreFormatError,
                               match="stale or swapped") as e:
                mod.open_block_store(p)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_ensure_block_store_reuses_recovers_and_rewrites(tmp_path):
    """The shared bootstrap narrates and decides as the reference does:
    reuse on a fingerprint match (mtime unchanged), rewrite when junk,
    stale or laid out differently — and the rewrites are the reference's
    bytes."""
    vectors, adj = _data(6, n=64, d=8, r=4)
    slot_of = np.random.default_rng(6).permutation(64)
    v2 = vectors.copy()
    v2[0, 0] += 1.0
    steps = [("absent", vectors, {}), ("reuse", vectors, {}),
             ("junk", vectors, {}), ("stale", v2, {}),
             ("relaid", v2, dict(nodes_per_block=8, slot_of=slot_of)),
             ("reuse-packed", v2, dict(nodes_per_block=8, slot_of=slot_of))]
    for mod, name in ((jbs, "ref"), (tbs, "port")):
        p = tmp_path / f"{name}.blocks"
        logs, mtimes = [], []
        for step, vecs, kw in steps:
            if step == "junk":
                p.write_bytes(b"not a store")
            msgs = []
            before = p.stat().st_mtime_ns if p.exists() else None
            store = mod.ensure_block_store(p, vecs, adj, log=msgs.append,
                                           **kw)
            logs.append([m.replace(name, "X") for m in msgs])
            mtimes.append(before == p.stat().st_mtime_ns)
            np.testing.assert_array_equal(
                store.read_many(np.arange(64))[0], vecs)
        if name == "ref":
            want_logs, want_mtimes = logs, mtimes
            want_bytes = p.read_bytes()
    assert logs == want_logs
    assert mtimes == want_mtimes == [False, True, False, False, False, True]
    assert any("laid out differently" in m for m in logs[4])
    assert p.read_bytes() == want_bytes


@settings(max_examples=10, deadline=None)
@given(frac=st.floats(0.0, 1.0), seed=st.integers(0, 2**31 - 1))
def test_crash_recovery_never_opens_a_torn_store(frac, seed):
    """A crash at any byte cut — a partial ``.tmp`` never renamed, or a torn
    published file — never opens (the port's typed error), and
    ``ensure_block_store`` always recovers by rewriting."""
    import shutil
    import tempfile

    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(16, 8)).astype(np.float32)
    adj = rng.integers(-1, 16, size=(16, 4)).astype(np.int32)
    tmpdir = pathlib.Path(tempfile.mkdtemp(prefix="mcgi-torch-crash-"))
    try:
        p = tmpdir / "c.blocks"
        tbs.write_block_store(p, vectors, adj)
        full = p.read_bytes()
        cut = int(frac * (len(full) - 1))
        p.unlink()
        tmp = p.with_name(p.name + ".tmp")
        tmp.write_bytes(full[:cut])
        with pytest.raises(tbs.BlockStoreFormatError):
            tbs.BlockStore(p)
        store = tbs.ensure_block_store(p, vectors, adj)
        np.testing.assert_array_equal(store.read_many(np.arange(16))[0],
                                      vectors)
        assert not tmp.exists()
        p.write_bytes(full[:cut])
        with pytest.raises(tbs.BlockStoreError):
            tbs.BlockStore(p)
        msgs = []
        store = tbs.ensure_block_store(p, vectors, adj, log=msgs.append)
        assert any("unreadable" in m for m in msgs)
        vr, ar = store.read_many(np.arange(16))
        np.testing.assert_array_equal(vr, vectors)
        np.testing.assert_array_equal(ar, adj)
        assert p.read_bytes() == full
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


@pytest.mark.parametrize("npb", [1, 2, 4, 8, 16])
def test_block_layout_equals_reference_on_a_built_graph(ref_graph, npb):
    _x, graph = ref_graph
    want = jbuild.block_layout(graph, npb)
    port_graph = convert.graph_index_from_arrays(
        {k: np.asarray(getattr(graph, k))
         for k in ("adj", "entry", "alpha", "lid", "mu", "sigma")}, "cpu")
    got = tbuild.block_layout(port_graph, npb)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert port_graph.degree_cap == graph.degree_cap


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("npb", [2, 3, 4, 8])
def test_greedy_block_pack_equals_reference_on_random_adjacency(seed, npb):
    """Duplicate ids in a row, self loops, INVALID padding and unreachable
    nodes: the same permutation."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 400))
    adj = rng.integers(-1, n, size=(n, int(rng.integers(1, 10))))
    entry = int(rng.integers(0, n))
    np.testing.assert_array_equal(
        tprune.greedy_block_pack(adj.astype(np.int32), entry, npb),
        jprune.greedy_block_pack(adj.astype(np.int32), entry, npb))


@pytest.mark.parametrize("limit", [1, 16, 256, 5000])
def test_entry_proximal_ids_equal_reference(ref_graph, limit):
    _x, graph = ref_graph
    want = jdisk.entry_proximal_ids(graph.adj, graph.entry, limit=limit)
    got = tdisk.entry_proximal_ids(torch.from_numpy(np.array(graph.adj)),
                                   torch.tensor(int(graph.entry)),
                                   limit=limit)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
