"""The port's baselines (``core/hnsw.py``, ``core/ivf.py``) and the walk from
a different entry point for each query, against the reference on the same
numpy inputs.

Tolerances: the HNSW build is the reference's host code, so its graph is
bit-identical on any data.  On integer-valued data every float32 sum is
exact in any order, so search results (ids, d2, hops, evaluations, points
scanned) must be bit-identical; on float data HNSW recall@10 stays within
0.01 of the reference's and IVF d2 within 1e-4.  The reference is imported
in a fixture, so the file's ``gpu`` tests run on the card without JAX.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distance as tdist  # noqa: E402
from repro_torch.core import hnsw as thnsw  # noqa: E402
from repro_torch.core import ivf as tivf  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import distance, hnsw, ivf, search
    from repro.data import make_dataset

    return types.SimpleNamespace(jax=jax, jnp=jnp, distance=distance,
                                 hnsw=hnsw, ivf=ivf, search=search,
                                 make_dataset=make_dataset)


@pytest.fixture(scope="module")
def tiny(ref):
    """The reference test's data: ``tiny-mixture`` x[:800], 40 queries."""
    x, q = ref.make_dataset("tiny-mixture", seed=0)
    return np.array(x)[:800], np.array(q)[:40]


@pytest.fixture(scope="module")
def hnsw_float(ref, tiny):
    x, _ = tiny
    return (ref.hnsw.build_hnsw(ref.jnp.asarray(x), m=12, ef_construction=64),
            thnsw.build_hnsw(x, m=12, ef_construction=64, device="cpu"))


def _same_graph(j, t):
    assert t.n_layers == j.n_layers
    assert int(t.entry) == int(j.entry)
    assert t.layers.dtype == torch.int32
    np.testing.assert_array_equal(t.layers.numpy(), np.asarray(j.layers))


def test_build_hnsw_float_bit_identical(hnsw_float):
    _same_graph(*hnsw_float)
    assert hnsw_float[1].n_layers > 1      # the descent has layers to walk


@pytest.mark.parametrize("seed", [0, 3])
def test_build_hnsw_integer_bit_identical(ref, seed):
    rng = np.random.default_rng(seed)
    x = _ints(rng, (500, 6))
    j = ref.hnsw.build_hnsw(ref.jnp.asarray(x), m=8, ef_construction=32,
                            seed=seed)
    t = thnsw.build_hnsw(T(x), m=8, ef_construction=32, seed=seed,
                         device="cpu")
    _same_graph(j, t)


@pytest.fixture(scope="module")
def hnsw_int(ref):
    rng = np.random.default_rng(1)
    x, q = _ints(rng, (600, 8)), _ints(rng, (48, 8))
    j = ref.hnsw.build_hnsw(ref.jnp.asarray(x), m=8, ef_construction=32)
    t = thnsw.build_hnsw(x, m=8, ef_construction=32, device="cpu")
    return x, q, j, t


@pytest.mark.parametrize("ef", [8, 24, 48])
def test_search_hnsw_integer_bit_identical(ref, hnsw_int, ef):
    x, q, j, t = hnsw_int
    ji, jd, js = ref.hnsw.search_hnsw(j, ref.jnp.asarray(x),
                                      ref.jnp.asarray(q), ef=ef, k=10)
    ti, td, ts = thnsw.search_hnsw(t, T(x), T(q), ef=ef, k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.hops.numpy(), np.asarray(js.hops))
    np.testing.assert_array_equal(ts.dist_evals.numpy(),
                                  np.asarray(js.dist_evals))


@pytest.mark.parametrize("ef", [16, 32, 64])
def test_search_hnsw_float_recall(ref, tiny, hnsw_float, ef):
    x, q = tiny
    j, t = hnsw_float
    _, gt = ref.distance.brute_force_topk(ref.jnp.asarray(q),
                                          ref.jnp.asarray(x), k=10)
    ji, _, _ = ref.hnsw.search_hnsw(j, ref.jnp.asarray(x), ref.jnp.asarray(q),
                                    ef=ef, k=10)
    ti, td, _ = thnsw.search_hnsw(t, T(x), T(q), ef=ef, k=10)
    r_ref = float(ref.distance.recall_at_k(ji, gt))
    r_port = float(tdist.recall_at_k(ti, T(np.asarray(gt))))
    assert r_port >= 0.90 and abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert (torch.diff(td, dim=1) >= 0).all()


def test_descend_counts_its_host_reads(hnsw_int):
    x, q, _, t = hnsw_int
    counter = {}
    entries = thnsw.descend(t, T(x), T(q), counter)
    assert entries.shape == (q.shape[0],) and entries.dtype == torch.int32
    assert counter["reads"] >= t.n_layers - 1
    # Every entry is a node of layer 1 or above when there are upper layers.
    assert ((t.layers[1][entries.long()] != -1).any(1)
            | (entries == t.entry)).all()


# ------------------------------------------------------------------- IVF


def _ref_init(ref, n: int, nlist: int, seed: int = 0):
    """The reference's ``jax.random.choice`` draw of initial centroid rows."""
    return np.array(ref.jax.random.choice(ref.jax.random.PRNGKey(seed), n,
                                          shape=(nlist,), replace=False))


@pytest.mark.parametrize("nlist,iters", [(16, 5), (40, 3)])
def test_build_ivf_matches_reference(ref, tiny, nlist, iters):
    x, _ = tiny
    j = ref.ivf.build_ivf(ref.jnp.asarray(x), nlist=nlist, iters=iters)
    t = tivf.build_ivf(x, nlist=nlist, iters=iters,
                       init=_ref_init(ref, x.shape[0], nlist), chunk=300,
                       device="cpu")
    np.testing.assert_array_equal(t.lists.numpy(), np.asarray(j.lists))
    np.testing.assert_array_equal(t.list_len.numpy(), np.asarray(j.list_len))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ivf_int(ref):
    rng = np.random.default_rng(2)
    x, q = _ints(rng, (700, 6)), _ints(rng, (37, 6))
    j = ref.ivf.build_ivf(ref.jnp.asarray(x), nlist=24, iters=4)
    t = tivf.build_ivf(x, nlist=24, iters=4, init=_ref_init(ref, 700, 24),
                       device="cpu")
    np.testing.assert_array_equal(t.lists.numpy(), np.asarray(j.lists))
    return x, q, j, t


@pytest.mark.parametrize("nprobe,k", [(1, 10), (3, 10), (8, 17), (24, 5)])
@pytest.mark.parametrize("scan_bytes", [1 << 30, 4096])
def test_search_ivf_integer_bit_identical(ref, ivf_int, nprobe, k,
                                          scan_bytes):
    x, q, j, t = ivf_int
    ji, jd, jn = ref.ivf.search_ivf(j, ref.jnp.asarray(x), ref.jnp.asarray(q),
                                    nprobe=nprobe, k=k)
    ti, td, tn = tivf.search_ivf(t, T(x), T(q), nprobe=nprobe, k=k,
                                 scan_bytes=scan_bytes)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_search_ivf_fewer_valid_than_k(ref):
    """A probe whose lists hold fewer than k points: the tail is INVALID at
    inf, as the reference's ``ids[order]`` gives it."""
    rng = np.random.default_rng(4)
    x, q = _ints(rng, (60, 4)), _ints(rng, (9, 4))
    j = ref.ivf.build_ivf(ref.jnp.asarray(x), nlist=12, iters=2)
    t = tivf.build_ivf(x, nlist=12, iters=2, init=_ref_init(ref, 60, 12),
                       device="cpu")
    ji, jd, jn = ref.ivf.search_ivf(j, ref.jnp.asarray(x), ref.jnp.asarray(q),
                                    nprobe=1, k=20)
    ti, td, tn = tivf.search_ivf(t, T(x), T(q), nprobe=1, k=20)
    assert (tn.numpy() < 20).any() and (ti.numpy() == -1).any()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("nprobe", [2, 8])
def test_search_ivf_float(ref, tiny, nprobe):
    x, q = tiny
    j = ref.ivf.build_ivf(ref.jnp.asarray(x), nlist=32, iters=4)
    t = tivf.build_ivf(x, nlist=32, iters=4,
                       init=_ref_init(ref, x.shape[0], 32), device="cpu")
    ji, jd, jn = ref.ivf.search_ivf(j, ref.jnp.asarray(x), ref.jnp.asarray(q),
                                    nprobe=nprobe, k=10)
    ti, td, tn = tivf.search_ivf(t, T(x), T(q), nprobe=nprobe, k=10)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    same = ti.numpy() == np.asarray(ji)
    assert same.mean() > 0.99, same.mean()


# ------------------------------------------------- walk with a lane entry


def _walk_problem(seed: int = 5, n: int = 300, q: int = 12, r: int = 10):
    rng = np.random.default_rng(seed)
    x, qs = _ints(rng, (n, 6)), _ints(rng, (q, 6))
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.1] = -1
    return x, qs, adj


@pytest.mark.parametrize("filtered", [False, True])
def test_lane_entries_equal_scalar_entry(filtered):
    """A (Q,) entry of one node everywhere walks exactly as the scalar."""
    x, qs, adj = _walk_problem()
    excl = None
    if filtered:
        allowed = np.random.default_rng(6).random((qs.shape[0], 300)) > 0.2
        allowed[:, 17] = False                # the entry itself excluded
        excl = tsearch.pack_filter(allowed, 300, device="cpu")
    ev = tsearch._exact_eval(T(x))
    want = tsearch.fixed_search_batch(T(qs), T(adj), 17, ev, 300, 16, 40,
                                      excl=excl)
    got = tsearch.fixed_search_batch(
        T(qs), T(adj), torch.full((qs.shape[0],), 17, dtype=torch.int32), ev,
        300, 16, 40, excl=excl)
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (got[2].hops, want[2].hops),
                 (got[2].dist_evals, want[2].dist_evals)):
        assert torch.equal(a, b)


def test_lane_entries_walk_as_the_reference(ref):
    """Each lane from its own entry: the reference's ``_search_one`` a lane
    (integer data: bit-identical)."""
    x, qs, adj = _walk_problem(seed=7)
    entries = np.random.default_rng(8).integers(0, 300, qs.shape[0]).astype(
        np.int32)
    ti, td, ts = tsearch.fixed_search_batch(T(qs), T(adj), T(entries),
                                            tsearch._exact_eval(T(x)), 300,
                                            16, 40)
    jnp = ref.jnp

    def ev(qq, ids, valid):
        return jnp.sum((jnp.asarray(x)[ids] - qq[None, :]) ** 2, axis=-1)

    for lane in range(qs.shape[0]):
        ji, jd, js = ref.search._search_one(
            jnp.asarray(qs[lane]), adj=jnp.asarray(adj),
            entry=jnp.int32(entries[lane]), eval_dists=ev, n=300,
            beam_width=16, max_hops=40)
        np.testing.assert_array_equal(ti[lane].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td[lane].numpy(), np.asarray(jd))
        assert int(ts.hops[lane]) == int(js.hops)
        assert int(ts.dist_evals[lane]) == int(js.dist_evals)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_search_hnsw_on_card_matches_cpu(cuda):
    """Integer data: the card's layer-0 walk (``beam_step`` exact) and
    descent give the CPU's ids, d2 and counters bit for bit."""
    rng = np.random.default_rng(9)
    x, q = _ints(rng, (2000, 16)), _ints(rng, (300, 16))
    cpu = thnsw.build_hnsw(x, m=8, ef_construction=40, device="cpu")
    card = thnsw.build_hnsw(x, m=8, ef_construction=40, device=cuda)
    want = thnsw.search_hnsw(cpu, T(x), T(q), ef=32)
    ops.reset_launch_counts()
    got = thnsw.search_hnsw(card, T(x).to(cuda), T(q).to(cuda), ef=32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["beam_step.exact"] == 1
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (got[2].hops, want[2].hops),
                 (got[2].dist_evals, want[2].dist_evals)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_search_ivf_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(10)
    x, q = _ints(rng, (5000, 16)), _ints(rng, (257, 16))
    init = rng.choice(5000, 40, replace=False)
    cpu = tivf.build_ivf(x, nlist=40, iters=3, init=init, device="cpu")
    card = tivf.build_ivf(x, nlist=40, iters=3, init=init, device=cuda)
    assert torch.equal(card.lists.cpu(), cpu.lists)
    want = tivf.search_ivf(cpu, T(x), T(q), nprobe=4, k=10)
    ops.reset_launch_counts()
    got = tivf.search_ivf(card, T(x).to(cuda), T(q).to(cuda), nprobe=4, k=10,
                          scan_bytes=1 << 20)
    torch.cuda.synchronize()
    assert ops.launch_counts()["topk"] >= 2
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
