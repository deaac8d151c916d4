"""The inner-product and cosine metrics, ``pq_decode``, the lam-only fit of
the dataset configs and the package surface of the port, against the
reference on the same numpy inputs.

Tolerances: on float data distances agree within 1e-4 relative (the
products run in another order) and ids are equal wherever the two
neighbours at a rank are not a near-tie (float64 distances within 1e-4
relative); on integer data every product is exact, so ``ip`` scans are
bit-identical (ties, -0.0 included).  LID from non-L2 distances is the
reference's ``lid_from_dists(squared=False)`` on negated products; its
numbers (NaN included) are matched, not judged.  The reference is imported
in a fixture, so the file's ``gpu`` tests run on the card without JAX.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import mcgi_datasets as tconfigs  # noqa: E402
from repro_torch.core import distance as tdist  # noqa: E402
from repro_torch.core import lid as tlid  # noqa: E402
from repro_torch.kernels import ops, ref as kref  # noqa: E402
from repro_torch.pq import codebook as tcodebook  # noqa: E402
from repro_torch.pq import encode as tencode  # noqa: E402

torch.set_num_threads(1)
METRICS = ("ip", "cosine")


def T(a):
    return torch.from_numpy(np.array(a))


def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import mcgi_datasets
    from repro.core import distance, lid
    from repro.pq import codebook, encode

    return types.SimpleNamespace(jax=jax, jnp=jnp, distance=distance,
                                 lid=lid, configs=mcgi_datasets,
                                 codebook=codebook, encode=encode)


def _float(seed: int, n: int, nq: int, d: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), np.float32),
            rng.standard_normal((nq, d), np.float32))


def _d64(q, x, metric):
    q, x = q.astype(np.float64), x.astype(np.float64)
    if metric == "cosine":
        q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
    return -(q @ x.T)


def _same_ids_outside_near_ties(got_i, want_i, q, x, metric, rtol=1e-4):
    """Ids equal at every rank, except where the two ids' float64
    distances are a near-tie (within ``rtol`` relative)."""
    d = _d64(q, x, metric)
    diff = np.argwhere(got_i != want_i)
    for r, c in diff:
        a, b = d[r, got_i[r, c]], d[r, want_i[r, c]]
        assert abs(a - b) <= rtol * max(abs(a), abs(b), 1e-6), (r, c, a, b)
    return len(diff)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_and_point_to_points_float(ref, metric):
    x, q = _float(0, 70, 9, 24)
    want = np.asarray(ref.distance.pairwise(ref.jnp.asarray(q),
                                            ref.jnp.asarray(x), metric))
    got = tdist.pairwise(T(q), T(x), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    one = tdist.point_to_points(T(q[3]), T(x), metric).numpy()
    np.testing.assert_allclose(
        one, np.asarray(ref.distance.point_to_points(
            ref.jnp.asarray(q[3]), ref.jnp.asarray(x), metric)),
        rtol=1e-4, atol=1e-5)


def test_ip_pairwise_integer_bit_identical(ref):
    rng = np.random.default_rng(1)
    x, q = _ints(rng, (50, 8)), _ints(rng, (6, 8))
    got = tdist.pairwise(T(q), T(x), "ip").numpy()
    want = np.asarray(ref.distance.pairwise(ref.jnp.asarray(q),
                                            ref.jnp.asarray(x), "ip"))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_unknown_metric_raises():
    x = torch.zeros((4, 3))
    for fn in (lambda: tdist.pairwise(x, x, "hamming"),
               lambda: tdist.brute_force_topk(x, x, 2, metric="l1"),
               lambda: tdist.knn_graph(x, 2, metric="dot")):
        with pytest.raises(ValueError, match="unknown metric"):
            fn()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 10, 70])
def test_brute_force_topk_float(ref, metric, k):
    x, q = _float(2, 500, 31, 20)
    jd, ji = ref.distance.brute_force_topk(ref.jnp.asarray(q),
                                           ref.jnp.asarray(x), k=k,
                                           metric=metric)
    td, ti = tdist.brute_force_topk(T(q), T(x), k, metric=metric, chunk=128)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    _same_ids_outside_near_ties(ti.numpy(), np.asarray(ji), q, x, metric)
    assert (np.diff(td.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("chunk", [7, 64, 65536])
@pytest.mark.parametrize("k", [5, 33])
def test_brute_force_topk_ip_integer_bit_identical(ref, chunk, k):
    """Integer products are exact and full of ties and -0.0: values bitwise
    and ids equal to the reference's stable merge, whatever the chunk."""
    rng = np.random.default_rng(3)
    x, q = _ints(rng, (300, 5), -2, 3), _ints(rng, (11, 5), -2, 3)
    q[0] = 0.0                                     # a row of -0.0 only
    jd, ji = ref.distance.brute_force_topk(ref.jnp.asarray(q),
                                           ref.jnp.asarray(x), k=k,
                                           metric="ip")
    td, ti = tdist.brute_force_topk(T(q), T(x), k, metric="ip", chunk=chunk)
    assert np.signbit(td.numpy()[0]).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))


@pytest.mark.parametrize("metric", METRICS)
def test_knn_graph(ref, metric):
    x, _ = _float(4, 260, 1, 12)
    jd, ji = ref.distance.knn_graph(ref.jnp.asarray(x), k=6, metric=metric,
                                    chunk_q=100)
    td, ti = tdist.knn_graph(T(x), 6, metric=metric, chunk_q=64, chunk=100)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    _same_ids_outside_near_ties(ti.numpy(), np.asarray(ji), x, x, metric)
    assert not (ti.numpy() == np.arange(260)[:, None]).any()


def test_knn_graph_ip_integer_bit_identical(ref):
    rng = np.random.default_rng(5)
    x = _ints(rng, (150, 4))
    jd, ji = ref.distance.knn_graph(ref.jnp.asarray(x), k=5, metric="ip",
                                    chunk_q=64)
    td, ti = tdist.knn_graph(T(x), 5, metric="ip", chunk_q=50, chunk=40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _close_or_both_nan(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=rtol)


@pytest.mark.parametrize("metric", ("l2",) + METRICS)
def test_estimate_dataset_lid_metric(ref, metric):
    """Positive inner products: ``x`` lies in the positive orthant, so the
    negated products are negative and clamp to the reference's 1e-12."""
    rng = np.random.default_rng(6)
    x = np.abs(rng.standard_normal((240, 10), np.float32))
    jp = ref.lid.estimate_dataset_lid(ref.jnp.asarray(x), k=8, chunk_q=100,
                                      metric=metric)
    tp = tlid.estimate_dataset_lid(T(x), k=8, chunk_q=64, chunk=100,
                                   metric=metric)
    _close_or_both_nan(tp.lid.numpy(), np.asarray(jp.lid), 1e-4)
    _close_or_both_nan(float(tp.mu), float(jp.mu), 1e-4)
    _close_or_both_nan(float(tp.sigma), float(jp.sigma), 1e-3)


@pytest.mark.parametrize("metric", ("l2",) + METRICS)
def test_bootstrap_stats_metric(ref, metric):
    x, _ = _float(7, 300, 1, 12)
    key = ref.jax.random.PRNGKey(3)
    idx = np.array(ref.jax.random.choice(key, 300, shape=(40,),
                                         replace=False))
    jm, js = ref.lid.bootstrap_stats(ref.jnp.asarray(x), key, sample=40, k=6,
                                     metric=metric)
    tm, ts = tlid.bootstrap_stats(T(x), sample=40, k=6, metric=metric,
                                  sample_idx=idx)
    _close_or_both_nan(float(tm), float(jm), 1e-4)
    _close_or_both_nan(float(ts), float(js), 1e-3)


# ------------------------------------------------------------- pq_decode


def test_pq_decode_matches_reference(ref):
    rng = np.random.default_rng(8)
    cents = rng.standard_normal((4, 16, 3), np.float32)
    codes = rng.integers(0, 16, (50, 4)).astype(np.uint8)
    want = ref.encode.pq_decode(ref.jnp.asarray(codes),
                                ref.codebook.PqCodebook(
                                    centroids=ref.jnp.asarray(cents)))
    got = tencode.pq_decode(T(codes), tcodebook.PqCodebook(centroids=T(cents)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (50, 12)


def test_pq_decode_inverts_encode_on_centroids():
    rng = np.random.default_rng(9)
    book = tcodebook.PqCodebook(centroids=T(rng.standard_normal(
        (2, 8, 4), np.float32)))
    codes = T(rng.integers(0, 8, (20, 2)).astype(np.uint8))
    assert torch.equal(tencode.pq_encode(tencode.pq_decode(codes, book),
                                         book), codes)


# ------------------------------------------------------ the lam-only fit


@pytest.mark.parametrize("target", [0.85, 0.9, 0.97])
def test_calibrated_beam_budget_matches_reference(ref, target):
    kw = dict(l_search=64, lam=0.3, recall_target=target)
    t = tconfigs.McgiDatasetConfig("t", 1000, 32, 16, 32, None, "float32",
                                   **kw)
    j = ref.configs.McgiDatasetConfig("t", 1000, 32, 16, 32, None,
                                      "float32", **kw)

    def curve(c):
        return 1.0 - 0.15 * c.lam - (0.1 if c.hop_factor < 8 else 0.0)

    got = t.calibrated_beam_budget(curve)
    want = j.calibrated_beam_budget(curve)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_calibrated_beam_budget_on_every_config(ref):
    def curve(c):
        return 0.99 - 0.05 * c.lam

    for name, t in tconfigs.DATASETS.items():
        j = next(c for c in ref.configs._DATASETS if c.name == name)
        assert dataclasses.asdict(t.calibrated_beam_budget(curve)) == \
            dataclasses.asdict(j.calibrated_beam_budget(curve))


# ------------------------------------------------------ package surface


@pytest.mark.parametrize("pkg", ["core", "data", "pq"])
def test_reference_exports_resolve_in_the_port(ref, pkg):
    import importlib

    jmod = importlib.import_module(f"repro.{pkg}")
    tmod = importlib.import_module(f"repro_torch.{pkg}")
    names = [n for n in vars(jmod) if not n.startswith("_")
             and not isinstance(getattr(jmod, n), types.ModuleType)]
    assert len(names) >= {"core": 30, "data": 6, "pq": 6}[pkg]
    missing = [n for n in names if not hasattr(tmod, n)]
    assert not missing, missing
    for n in names:
        assert callable(getattr(tmod, n)) or isinstance(getattr(tmod, n),
                                                        float)


def test_core_names_the_baselines_and_oracles():
    from repro_torch import core
    from repro_torch.core import hnsw, ivf, theory

    assert core.hnsw is hnsw and core.ivf is ivf and core.theory is theory
    assert hnsw.build_hnsw and ivf.build_ivf and theory.rng_edges
    with pytest.raises(AttributeError):
        core.no_such_name  # noqa: B018


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _negative_rows(g, q: int, n: int, dev):
    """Negated integer products with planted ties and both zeros."""
    d = -torch.randint(-6, 7, (q, n), generator=g, device=dev).float()
    d[:, ::7] = 0.0
    d[:, 3::7] = -0.0
    d[0] = -0.0
    d[1] = 0.0
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 64, 100, 200, 300])
@pytest.mark.parametrize("q,n", [(5, 1000), (64, 70_000), (3, 250_000)])
def test_topk_negative_rows_match_plain_on_card(cuda, q, n, k):
    g = torch.Generator(device=cuda).manual_seed(q * n + k)
    d = _negative_rows(g, q, n, cuda)
    got_v, got_i = ops.topk(d, k)
    want_v, want_i = kref.topk_ref(d, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_topk_on_card_matches_cpu(cuda, metric):
    rng = np.random.default_rng(10)
    x, q = _ints(rng, (20_000, 16)), _ints(rng, (64, 16))
    want_d, want_i = tdist.brute_force_topk(T(q), T(x), 10, metric=metric)
    ops.reset_launch_counts()
    got_d, got_i = tdist.brute_force_topk(T(q).to(cuda), T(x).to(cuda), 10,
                                          metric=metric, chunk=4096)
    torch.cuda.synchronize()
    assert ops.launch_counts()["topk"] == 5
    if metric == "ip":
        assert torch.equal(got_i.cpu(), want_i)
        assert torch.equal(got_d.cpu().view(torch.int32),
                           want_d.view(torch.int32))
    else:
        torch.testing.assert_close(got_d.cpu(), want_d, rtol=1e-4,
                                   atol=1e-5)
