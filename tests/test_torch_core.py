"""The port's core modules (distance, LID, mapping, search grant, prune,
build) against the reference on the same numpy inputs.

Tolerances: integer-valued inputs make every float32 sum exact in any
order, so ids, rows and distances must be equal; on float data distances
agree to 1e-4 (the reference's own f32 L2 tolerance) and LID to 1e-5
relative (reductions in another order move the last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build as jbuild  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro.core import lid as jlid  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import distance as tdist  # noqa: E402
from repro_torch.core import lid as tlid  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy


def _ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


def test_squared_l2_float():
    rng = np.random.default_rng(0)
    q, x = rng.standard_normal((7, 24), np.float32), rng.standard_normal(
        (50, 24), np.float32)
    np.testing.assert_allclose(tdist.squared_l2(T(q), T(x)).numpy(),
                               np.asarray(jdist.squared_l2(q, x)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [64, 1000, 65536])
def test_brute_force_topk_ties_go_to_lowest_id(chunk):
    """Integer data is full of exact ties: ids must match the reference's
    stable chunked merge whatever the port's chunk size."""
    rng = np.random.default_rng(1)
    x, q = _ints(rng, (300, 6)), _ints(rng, (9, 6))
    jd, ji = jdist.brute_force_topk(jnp.asarray(q), jnp.asarray(x), k=12)
    td, ti = tdist.brute_force_topk(T(q), T(x), 12, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_brute_force_topk_fewer_points_than_k():
    rng = np.random.default_rng(2)
    x, q = _ints(rng, (5, 4)), _ints(rng, (3, 4))
    jd, ji = jdist.brute_force_topk(jnp.asarray(q), jnp.asarray(x), k=8)
    td, ti = tdist.brute_force_topk(T(q), T(x), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_knn_graph_integer():
    rng = np.random.default_rng(3)
    x = _ints(rng, (200, 5))
    jd, ji = jdist.knn_graph(jnp.asarray(x), k=7, chunk_q=64)
    td, ti = tdist.knn_graph(T(x), 7, chunk_q=50, chunk=48)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_recall_at_k():
    rng = np.random.default_rng(4)
    p, t = rng.integers(0, 30, (20, 10)), rng.integers(0, 30, (20, 10))
    assert float(tdist.recall_at_k(T(p), T(t))) == pytest.approx(
        float(jdist.recall_at_k(jnp.asarray(p), jnp.asarray(t))), abs=1e-7)


def test_lid_estimators():
    rng = np.random.default_rng(5)
    d2 = (rng.random((64, 16), np.float32) + 0.01).astype(np.float32)
    np.testing.assert_allclose(tlid.lid_from_dists(T(d2)).numpy(),
                               np.asarray(jlid.lid_from_dists(d2)), rtol=1e-5)
    r = np.sort(np.sqrt(d2[0]))
    np.testing.assert_allclose(float(tlid.lid_from_sorted_dists(T(r))),
                               float(jlid.lid_from_sorted_dists(r)), rtol=1e-5)
    pool = d2.copy()
    pool[:, 10:] = np.inf                      # inf tails take the max finite
    pool[0, 1:] = np.inf
    np.testing.assert_allclose(tlid.online_lid(T(pool), 12).numpy(),
                               np.asarray(jlid.online_lid(pool, k=12)),
                               rtol=1e-5)


def test_calibrate_uses_population_std():
    lid = np.random.default_rng(6).random(101).astype(np.float32) * 20
    t, j = tlid.calibrate(T(lid)), jlid.calibrate(jnp.asarray(lid))
    np.testing.assert_allclose(float(t.mu), float(j.mu), rtol=1e-6)
    np.testing.assert_allclose(float(t.sigma), float(j.sigma), rtol=1e-6)
    assert float(t.sigma) == pytest.approx(float(np.std(lid)), rel=1e-6)


def test_estimate_dataset_lid_float():
    x = np.random.default_rng(7).standard_normal((300, 12)).astype(np.float32)
    t = tlid.estimate_dataset_lid(T(x), k=10, chunk_q=128)
    j = jlid.estimate_dataset_lid(jnp.asarray(x), k=10, chunk_q=128)
    np.testing.assert_allclose(t.lid.numpy(), np.asarray(j.lid), rtol=1e-4)
    np.testing.assert_allclose(float(t.sigma), float(j.sigma), rtol=1e-4)


def test_phi_and_budget_law():
    rng = np.random.default_rng(8)
    lid = (rng.random(200) * 30).astype(np.float32)
    np.testing.assert_allclose(
        tmap.phi(T(lid), 12.0, 4.0).numpy(),
        np.asarray(jmap.phi(jnp.asarray(lid), 12.0, 4.0)), rtol=1e-6)
    for mu in (None, 14.0):
        got = tmap.adaptive_beam_budget(T(lid), 0.25, 8, 128, mu=mu)
        want = jmap.adaptive_beam_budget(jnp.asarray(lid), 0.25, 8, 128,
                                         mu=mu)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # round half to even, as jnp.round
    half = torch.tensor([2.5, 3.5, -0.5])
    assert torch.round(half).tolist() == [2.0, 4.0, -0.0]


@pytest.mark.parametrize("center", [None, 6.5])
def test_grant_budgets_alone(center):
    """Same probe state in, same budgets and hop limits out; LID to 1e-5."""
    rng = np.random.default_rng(9)
    q, width = 40, 32
    ids = rng.integers(0, 500, (q, width)).astype(np.int32)
    d = np.sort(rng.random((q, width)).astype(np.float32) * 40, axis=1)
    ids[:, 20:], d[:, 20:] = -1, np.inf
    ids[3, 5:], d[3, 5:] = -1, np.inf
    cfg_kw = dict(l_min=8, l_max=width, lam=0.3, center=center)
    jcfg, tcfg = (jsearch.AdaptiveBeamBudget(**cfg_kw),
                  tsearch.AdaptiveBeamBudget(**cfg_kw))
    jb, jh, jq = jsearch.grant_budgets((jnp.asarray(ids), jnp.asarray(d)),
                                       jcfg, max_hops=100)
    tb, th, tq = tsearch.grant_budgets((T(ids), T(d)), tcfg, max_hops=100)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_budget_buckets():
    for args in [(16, 96, 4), (8, 128, 4), (8, 8, 3), (5, 100, 8)]:
        assert tsearch.budget_bucket_ceilings(*args) == \
            jsearch.budget_bucket_ceilings(*args)
    b = np.array([8, 9, 16, 17, 64, 100, 128], np.int32)
    ci, cb = tsearch.quantize_budgets(T(b), (8, 16, 64, 128))
    ji, jb = jsearch.quantize_budgets(jnp.asarray(b), (8, 16, 64, 128))
    np.testing.assert_array_equal(ci.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jb))


def test_pack_filter_words():
    allowed = np.random.default_rng(10).random((4, 100)) < 0.6
    words = tsearch.pack_filter(allowed, 100, device="cpu")
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32),
        np.asarray(jsearch.pack_filter(allowed, 100)))


def _prune_problem(seed, b=12, c=20, n=60, d=6):
    rng = np.random.default_rng(seed)
    x = _ints(rng, (n, d))
    node_ids = rng.choice(n, b, replace=False).astype(np.int32)
    cand = rng.integers(0, n, (b, c)).astype(np.int32)   # dups + self edges
    cand[rng.random((b, c)) < 0.2] = -1
    cand[0, 3] = node_ids[0]
    alpha = rng.uniform(1.0, 1.5, b).astype(np.float32)
    return x, node_ids, cand, alpha


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_robust_prune_batch_integer(seed):
    x, node_ids, cand, alpha = _prune_problem(seed)
    jr, jd = jprune.robust_prune_batch(jnp.asarray(x), jnp.asarray(node_ids),
                                       jnp.asarray(cand), jnp.asarray(alpha),
                                       degree=8)
    tr, td = tprune.robust_prune_batch(T(x), T(node_ids), T(cand), T(alpha), 8)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_reverse_pairs_identical():
    rng = np.random.default_rng(11)
    node_ids = rng.choice(400, 40, replace=False).astype(np.int32)
    rows = rng.integers(0, 60, (40, 9)).astype(np.int32)  # crowded dests
    rows[rng.random(rows.shape) < 0.15] = -1
    for cap in (3, 16):
        jd, jc = jbuild._reverse_pairs(node_ids, rows, cap)
        td, tc = tbuild._reverse_pairs(T(node_ids), T(rows), cap)
        np.testing.assert_array_equal(td.numpy(), jd)
        np.testing.assert_array_equal(tc.numpy(), jc)
    jd, jc = jbuild._reverse_pairs(node_ids, np.full_like(rows, -1), 4)
    td, tc = tbuild._reverse_pairs(T(node_ids), T(np.full_like(rows, -1)), 4)
    assert td.numel() == jd.size == 0 and tuple(tc.shape) == jc.shape


def test_insert_reverse_masks_pad_lanes():
    rng = np.random.default_rng(12)
    n, r = 64, 6
    x = _ints(rng, (n, 5))
    adj = np.stack([rng.choice(n, r, replace=False)
                    for _ in range(n)]).astype(np.int32)
    alpha = rng.uniform(1.0, 1.5, n).astype(np.float32)
    dest = np.array([3, 9, 40, 3, 3], np.int32)           # two pad lanes
    cand = rng.integers(0, n, (5, 4)).astype(np.int32)
    cand[3:] = -1
    valid = np.array([True, True, True, False, False])
    cfg = jbuild.BuildConfig(degree=r)
    want = jbuild._insert_reverse(jnp.asarray(x), jnp.asarray(adj),
                                  jnp.asarray(alpha), jnp.asarray(dest),
                                  jnp.asarray(cand), cfg,
                                  valid=jnp.asarray(valid))
    got = tbuild._insert_reverse(T(x), T(adj.copy()), T(alpha), T(dest),
                                 T(cand), tbuild.BuildConfig(degree=r),
                                 valid=T(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _build_problem(seed=13, n=128, d=6, r=8):
    # n = 128 and small integers keep the centroid (and so the medoid)
    # exact in float32 whatever the reduction order.
    rng = np.random.default_rng(seed)
    x = _ints(rng, (n, d), -4, 5)
    alpha = rng.uniform(1.0, 1.5, n).astype(np.float32)
    key = jax.random.PRNGKey(0)
    init_adj = np.array(jbuild.random_graph(n, r, key))
    perms = [np.array(jax.random.permutation(jax.random.fold_in(key, it + 1),
                                               n)) for it in range(2)]
    return x, alpha, init_adj, perms


def test_medoid_integer():
    x, *_ = _build_problem()
    assert int(tsearch.medoid(T(x))) == int(jsearch.medoid(jnp.asarray(x)))


def test_build_with_alpha_matches_reference():
    """Two refinement rounds from the reference's initial graph and
    permutations.  batch=1 leaves no padded lane anywhere in the reference
    loop, so its result is the reference's own (see the padded case below)."""
    x, alpha, init_adj, perms = _build_problem()
    kw = dict(degree=8, beam_width=12, iters=2, batch=1, max_hops=40,
              reverse_cap=4)
    want = jbuild.build_with_alpha(jnp.asarray(x), jnp.asarray(alpha),
                                   jbuild.BuildConfig(**kw),
                                   init_adj=jnp.asarray(init_adj))
    got = tbuild.build_with_alpha(T(x), T(alpha), tbuild.BuildConfig(**kw),
                                  init_adj=T(init_adj), perms=perms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_with_alpha_padded_batches():
    """batch=16: the reference's own pieces (rewire, reverse pairs, masked
    reverse insert) assembled as its loop runs them, with the pad lanes of
    each reverse chunk masked out, equal the port's build."""
    x, alpha, init_adj, perms = _build_problem(seed=14)
    kw = dict(degree=8, beam_width=12, iters=2, batch=16, max_hops=40,
              reverse_cap=4)
    cfg = jbuild.BuildConfig(**kw)
    xj, aj = jnp.asarray(x), jnp.asarray(alpha)
    adj = jnp.asarray(init_adj)
    entry = jsearch.medoid(xj)
    for perm in perms:
        for start in range(0, x.shape[0], cfg.batch):
            ids = perm[start:start + cfg.batch]
            new_rows, _ = jbuild._rewire_batch(xj, adj, aj, entry,
                                               jnp.asarray(ids), cfg)
            adj = adj.at[jnp.asarray(ids)].set(new_rows)
            dest, cand = jbuild._reverse_pairs(ids, np.asarray(new_rows),
                                               cfg.reverse_cap)
            for ds in range(0, dest.shape[0], cfg.batch):
                dsl, csl = dest[ds:ds + cfg.batch], cand[ds:ds + cfg.batch]
                valid = np.ones(cfg.batch, bool)
                valid[dsl.size:] = False
                pad = cfg.batch - dsl.size
                dsl = np.concatenate([dsl, dsl[:1].repeat(pad)])
                csl = np.concatenate([csl, np.full((pad, cfg.reverse_cap), -1,
                                                   np.int32)])
                adj = jbuild._insert_reverse(xj, adj, aj, jnp.asarray(dsl),
                                             jnp.asarray(csl), cfg,
                                             valid=jnp.asarray(valid))
    got = tbuild.build_with_alpha(T(x), T(alpha), tbuild.BuildConfig(**kw),
                                  init_adj=T(init_adj), perms=perms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(adj))


@pytest.mark.parametrize("builder", ["mcgi", "vamana"])
def test_builders_cpu_smoke(builder):
    """The port's own draws: a navigable graph (every point finds itself),
    MCGI's alpha inside [alpha_min, alpha_max], Vamana's constant."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    cfg = tbuild.BuildConfig(degree=8, beam_width=16, batch=64, max_hops=48)
    timings = {}
    if builder == "mcgi":
        g = tbuild.build_mcgi(x, cfg, device="cpu", timings=timings)
        assert set(timings) == {"lid_knn", "rewire_walks", "prune",
                                "reverse_insert"}
        assert float(g.alpha.min()) >= 1.0 and float(g.alpha.max()) <= 1.5
    else:
        g = tbuild.build_vamana(x, 1.2, cfg, device="cpu")
        assert torch.all(g.alpha == 1.2)
    assert tuple(g.adj.shape) == (400, 8) and g.adj.dtype == torch.int32
    ids, _, _ = tsearch.beam_search_exact(T(x), g.adj, T(x[:20]), g.entry,
                                          beam_width=16, k=1)
    assert (ids[:, 0].numpy() == np.arange(20)).mean() >= 0.95
