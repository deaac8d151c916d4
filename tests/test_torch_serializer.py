"""The port's index serializer against the reference's, both ways.

An index the reference built is saved by each package in every format
(v1, v2, v2 with a packed sidecar) with every manifest rider (disk model,
shard laws, lineage) and loaded by both.  The manifests must be equal as
dicts, the arrays equal as arrays with the reference's dtypes, and the
``.blocks`` sidecars equal byte for byte (``.npz`` files carry zip
timestamps, so they are not compared as bytes).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.core import build as jbuild  # noqa: E402
from repro.data import make_dataset  # noqa: E402
from repro.index import build_tiered_index  # noqa: E402
from repro.index import serializer as jser  # noqa: E402
from repro.index.disk import DiskTierModel as JModel  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.index import blockstore as tbs  # noqa: E402
from repro_torch.index import convert  # noqa: E402
from repro_torch.index import disk as tdisk  # noqa: E402
from repro_torch.index import serializer as tser  # noqa: E402

torch.set_num_threads(1)
FIELDS = ("adj", "entry", "alpha", "lid", "mu", "sigma", "centroids",
          "codes", "vectors")
LAWS = (np.asarray([0.188, 0.0, 0.5, 1.0], np.float32),
        np.asarray([2, 8, 4, 16], np.int32))
LINEAGE = {"generation": 3, "inserts": 17, "deletes": 2,
           "drift": {"mu": 0.25, "sigma": -0.5}}
FORMATS = {"v1": dict(version=1), "v2": dict(version=2),
           "v2-packed4": dict(version=2, nodes_per_block=4)}


def _ref_arrays(index) -> dict:
    g = index.graph
    return {"adj": g.adj, "entry": g.entry, "alpha": g.alpha, "lid": g.lid,
            "mu": g.mu, "sigma": g.sigma,
            "centroids": index.codebook.centroids, "codes": index.codes,
            "vectors": index.vectors}


def _host(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _arrays(index) -> dict:
    return {k: _host(v) for k, v in _ref_arrays(index).items()}


def _manifest(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["manifest"]))


def _npz_arrays(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != "manifest"}


@pytest.fixture(scope="module")
def built():
    x, q = make_dataset("tiny-uniform", seed=0)
    x, q = x[:1000], q[:24]
    cfg = jbuild.BuildConfig(degree=12, beam_width=24, iters=1, batch=250,
                             max_hops=48)
    ref = build_tiered_index(x, jbuild.build_mcgi(x, cfg), m_pq=8)
    port = convert.tiered_index_from_arrays(_arrays(ref), "cpu")
    return ref, port, np.array(q)


def _save(writer, path, index_pair, fmt):
    ref, port = index_pair
    kw = dict(FORMATS[fmt])
    if kw.get("nodes_per_block", 1) > 1:
        kw["slot_of"] = jbuild.block_layout(ref.graph, kw["nodes_per_block"])
    if writer == "ref":
        jser.save_index(path, ref, disk_model=JModel(20.0, 16),
                        shard_laws=LAWS, lineage=LINEAGE, **kw)
    else:
        if "slot_of" in kw:
            kw["slot_of"] = tbuild.block_layout(port.graph,
                                                kw["nodes_per_block"])
        tser.save_index(path, port, disk_model=tdisk.DiskTierModel(20.0, 16),
                        shard_laws=LAWS, lineage=LINEAGE, **kw)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_port_writes_what_the_reference_writes(built, tmp_path, fmt):
    ref, port, _ = built
    pr, pp = tmp_path / "ref.npz", tmp_path / "port.npz"
    _save("ref", pr, (ref, port), fmt)
    _save("port", pp, (ref, port), fmt)
    mr, mp = _manifest(pr), _manifest(pp)
    if "blocks" in mr:
        assert mr["blocks"].pop("file") == "ref.npz.blocks"
        assert mp["blocks"].pop("file") == "port.npz.blocks"
        assert (tser.blocks_path(pr).read_bytes()
                == tser.blocks_path(pp).read_bytes())
    assert mp == mr
    ar, ap = _npz_arrays(pr), _npz_arrays(pp)
    assert sorted(ap) == sorted(ar)
    for k in ar:
        assert ap[k].dtype == ar[k].dtype, k
        assert ap[k].shape == ar[k].shape, k
        np.testing.assert_array_equal(ap[k], ar[k], err_msg=k)


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_each_package_loads_the_others_index(built, tmp_path, writer, fmt):
    ref, port, _ = built
    p = tmp_path / "idx.npz"
    _save(writer, p, (ref, port), fmt)
    want = _arrays(jser.load_index(p))
    got = _arrays(tser.load_index(p, device="cpu"))
    orig = _arrays(ref)
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype == orig[k].dtype, k
        assert got[k].shape == want[k].shape == orig[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], orig[k], err_msg=k)
    assert tser.load_disk_model(p) == tdisk.DiskTierModel(20.0, 16)
    assert jser.load_disk_model(p) == JModel(20.0, 16)
    for mod in (tser, jser):
        lam, l_min = mod.load_shard_laws(p)
        assert lam.dtype == np.float32 and l_min.dtype == np.int32
        np.testing.assert_array_equal(lam, LAWS[0])
        np.testing.assert_array_equal(l_min, LAWS[1])
        assert mod.load_lineage(p) == LINEAGE


def test_riders_are_optional(built, tmp_path):
    ref, port, _ = built
    p = tmp_path / "plain.npz"
    tser.save_index(p, port)
    assert tser.load_disk_model(p) is None
    assert tser.load_shard_laws(p) is None
    assert tser.load_lineage(p) is None
    assert jser.load_disk_model(p) is None
    assert _manifest(p) == {"format": tser.FORMAT_V1, "n": 1000,
                            "degree": 12, "m_pq": 8}
    assert tser.FORMAT_V1 == jser.FORMAT_V1
    assert tser.FORMAT_V2 == jser.FORMAT_V2


def test_v1_loads_under_v2_and_migrates(built, tmp_path):
    """v1 -> load -> v2 -> load -> v1 -> load keeps every array and rider;
    the reference loads every leg alike."""
    _ref, port, _ = built
    p1, p2, p1b = (tmp_path / n for n in ("v1.npz", "v2.npz", "v1b.npz"))
    kw = dict(disk_model=tdisk.DiskTierModel(20.0, 16), shard_laws=LAWS)
    tser.save_index(p1, port, **kw)
    assert not tser.blocks_path(p1).exists()
    loaded1 = tser.load_index(p1, device="cpu")
    tser.save_index(p2, loaded1, version=2, **kw)
    assert _manifest(p2)["format"] == tser.FORMAT_V2
    loaded2 = tser.load_index(p2, device="cpu")
    tser.save_index(p1b, loaded2, version=1, **kw)
    orig = _arrays(port)
    for p in (p1, p2, p1b):
        for idx in (tser.load_index(p, device="cpu"), jser.load_index(p)):
            got = _arrays(idx)
            for k in FIELDS:
                np.testing.assert_array_equal(got[k], orig[k], err_msg=k)
        assert tser.load_disk_model(p) == tdisk.DiskTierModel(20.0, 16)


def test_unknown_version_rejected(built, tmp_path):
    _ref, port, _ = built
    with pytest.raises(ValueError, match="unknown index format version"):
        tser.save_index(tmp_path / "v3.npz", port, version=3)
    p = tmp_path / "weird.npz"
    tser.save_index(p, port)
    arrays, manifest = _npz_arrays(p), _manifest(p)
    manifest["format"] = "repro.tiered_index.v99"
    np.savez_compressed(p, manifest=json.dumps(manifest), **arrays)
    with pytest.raises(ValueError, match="v99"):
        tser.load_index(p, device="cpu")
    with pytest.raises(ValueError, match="v99"):
        jser.load_index(p)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_v2_sidecar_serves_the_slow_tier(built, tmp_path, writer):
    ref, port, _ = built
    p = tmp_path / "v2.npz"
    _save(writer, p, (ref, port), "v2")
    tier = tser.load_slow_tier(p, cache_nodes=64, pin_nodes=16)
    jtier = jser.load_slow_tier(p, cache_nodes=64, pin_nodes=16)
    try:
        assert sorted(tier._pinned) == sorted(jtier._pinned)
        assert tier.stats()["pinned_nodes"] == 16
        beams = np.asarray([[0, 5, -1], [7, 7, 2]])
        np.testing.assert_array_equal(tier.fetch_beams(beams),
                                      jtier.fetch_beams(beams))
        want = np.zeros((*beams.shape, 32), np.float32)
        want[beams >= 0] = _arrays(ref)["vectors"][beams[beams >= 0]]
        np.testing.assert_array_equal(tier.fetch_beams(beams), want)
    finally:
        tier.close()
        jtier.close()
    p1 = tmp_path / "v1.npz"
    tser.save_index(p1, port)
    with pytest.raises(tbs.BlockStoreFormatError, match="version=2"):
        tser.load_slow_tier(p1)


def test_packed_sidecar_pins_its_layout(built, tmp_path):
    """A packed sidecar swapped for a node-order rewrite of the same content
    is refused; a default-layout save carries no layout keys."""
    _ref, port, _ = built
    p = tmp_path / "packed.npz"
    tser.save_index(p, port, version=2, nodes_per_block=8,
                    slot_of=tbuild.block_layout(port.graph, 8))
    blk = _manifest(p)["blocks"]
    assert blk["nodes_per_block"] == 8 and blk["layout"] == "packed"
    store = tser.open_block_store(p)
    assert store.nodes_per_block == 8 and store.layout == "packed"
    tbs.write_block_store(tser.blocks_path(p), port.vectors.numpy(),
                          port.graph.adj.numpy())
    with pytest.raises(tbs.BlockStoreFormatError, match="stale or swapped"):
        tser.open_block_store(p)
    p1 = tmp_path / "plain.npz"
    tser.save_index(p1, port, version=2)
    assert "nodes_per_block" not in _manifest(p1)["blocks"]


@pytest.mark.parametrize("fmt", ["v1", "v2-packed4"])
def test_loaded_index_serves_bit_identically(built, tmp_path, fmt):
    """A reference-written file loaded by the port serves exactly what the
    port's in-memory copy serves, fixed and adaptive."""
    ref, port, q = built
    p = tmp_path / "idx.npz"
    _save("ref", p, (ref, port), fmt)
    loaded = tser.load_index(p, device="cpu")
    qt = torch.from_numpy(q)
    a = tdisk.search_tiered(port, qt, beam_width=24, k=10)
    b = tdisk.search_tiered(loaded, qt, beam_width=24, k=10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    cfg = tsearch.AdaptiveBeamBudget(l_min=8, l_max=24, lam=0.3)
    a = tdisk.search_tiered_adaptive(port, qt, cfg, k=10, num_buckets=3)
    b = tdisk.search_tiered_adaptive(loaded, qt, cfg, k=10, num_buckets=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal of the default device")
def test_load_index_defaults_to_the_card(built, tmp_path):
    _ref, port, _ = built
    p = tmp_path / "idx.npz"
    tser.save_index(p, port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tser.load_index(p)
