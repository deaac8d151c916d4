"""The port's budget-law calibration (``core/calibrate.py``, the engine's
``recalibrate``, ``launch.serve --calibrate``) and its MCGI dataset configs
against the reference.

* The fits on scripted evaluators are pure control flow: results and
  histories must be identical.
* The recall evaluators run on the integer twin of an index the reference
  built (vectors, queries and codebook scaled by 4 and rounded), so walks are
  bit-identical, and recall is taken as the reference takes its mean (the
  hit count times the float32 reciprocal of the count): every fit, with its
  whole history, must be identical.  Budgets come from ``round(exp(...))``
  of an online LID whose last bit may differ between the frameworks, so
  ``_candidate_grants`` is also held on its own to the reference's, fed the
  reference's probe ``q_lid``: budgets and hop limits exactly equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import mcgi_datasets as jconfigs  # noqa: E402
from repro.core import build as jbuild  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.types import GraphIndex  # noqa: E402
from repro.index import build_tiered_index  # noqa: E402
from repro.index import disk as jdisk  # noqa: E402
from repro.pq import PqCodebook, pq_encode  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import mcgi_datasets as tconfigs  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.index import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

torch.set_num_threads(1)
N, NQ, K, SAMPLE = 1500, 40, 10, 32
CFG = jbuild.BuildConfig(degree=12, beam_width=24, iters=1, batch=125,
                         max_hops=48)
BASE_KW = dict(l_min=8, l_max=24, lam=0.0, probe_hops=4, hop_factor=1)


def _budgets(**kw):
    return (jsearch.AdaptiveBeamBudget(**{**BASE_KW, **kw}),
            tsearch.AdaptiveBeamBudget(**{**BASE_KW, **kw}))


def _same_fit(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.fixture(scope="module")
def world(tiny_dataset):
    x, q = tiny_dataset
    x, q = x[:N], q[:NQ]
    graph = jbuild.build_mcgi(x, CFG)
    tiered = build_tiered_index(x, graph, m_pq=8)
    xi = np.round(np.asarray(x) * 4).astype(np.float32)
    qi = np.round(np.asarray(q) * 4).astype(np.float32)
    book_i = PqCodebook(jnp.round(tiered.codebook.centroids * 4))
    ti = jdisk.TieredIndex(
        graph=GraphIndex(adj=graph.adj, entry=graph.entry, alpha=graph.alpha,
                         lid=graph.lid, mu=graph.mu, sigma=graph.sigma),
        codebook=book_i, codes=pq_encode(jnp.asarray(xi), book_i),
        vectors=jnp.asarray(xi))
    _, gt = jdist.brute_force_topk(jnp.asarray(qi), jnp.asarray(xi), k=K)
    arrays = {k: np.asarray(v) for k, v in dict(
        adj=graph.adj, entry=graph.entry, alpha=graph.alpha, lid=graph.lid,
        mu=graph.mu, sigma=graph.sigma, centroids=ti.codebook.centroids,
        codes=ti.codes, vectors=ti.vectors).items()}
    return dict(xi=xi, qi=qi, gt=np.array(gt), tiered=ti,
                port=convert.tiered_index_from_arrays(arrays, "cpu"))


def _evals(world, kind):
    """(reference make_eval, port make_eval) over the integer twin."""
    xi, qi, gt, ti, port = (world[k] for k in
                            ("xi", "qi", "gt", "tiered", "port"))
    kw = dict(k=K, sample=SAMPLE, seed=0)
    if kind == "exact":
        return (lambda c: jcal.exact_recall_eval(
                    jnp.asarray(xi), ti.graph.adj, ti.graph.entry, qi, gt,
                    base_cfg=c, **kw),
                lambda c: tcal.exact_recall_eval(
                    port.vectors, port.graph.adj, port.graph.entry, qi, gt,
                    base_cfg=c, **kw))
    return (lambda c: jcal.tiered_recall_eval(ti, qi, gt, base_cfg=c, **kw),
            lambda c: tcal.tiered_recall_eval(port, qi, gt, base_cfg=c, **kw))


# ------------------------------------------------- scripted evaluators


CURVES = {
    "linear": lambda lam: 1.0 - 0.25 * lam,
    "step": lambda lam: 0.97 if lam < 0.37 else 0.8,
    "flat_low": lambda lam: 0.3,
    "flat_high": lambda lam: 0.99,
}


@pytest.mark.parametrize("curve", list(CURVES))
@pytest.mark.parametrize("tol,max_iters", [(0.01, 12), (0.02, 8), (0.2, 3)])
def test_bisect_lam_identical(curve, tol, max_iters):
    f = CURVES[curve]
    got = tcal.bisect_lam(f, 0.9, 0.0, 1.0, tol=tol, max_iters=max_iters)
    want = jcal.bisect_lam(f, 0.9, 0.0, 1.0, tol=tol, max_iters=max_iters)
    assert got == want


def _scripted(cfg):
    """Recall falls in lam, rises with hop_factor and l_min."""
    return min(1.0, 0.7 + 0.03 * cfg.hop_factor + 0.01 * cfg.l_min
               - 0.2 * cfg.lam)


@pytest.mark.parametrize("target", [0.8, 0.9, 0.97, 1.5])
def test_calibrate_budget_law_identical(target):
    jb, tb = _budgets(l_min=4, l_max=32, lam=0.2, hop_factor=2)
    got = tcal.calibrate_budget_law(_scripted, tb, target, max_hop_factor=16)
    want = jcal.calibrate_budget_law(_scripted, jb, target, max_hop_factor=16)
    _same_fit(got, want)
    assert dataclasses.asdict(got.budget_cfg(tb)) == dataclasses.asdict(
        want.budget_cfg(jb))


@pytest.mark.parametrize("target", [0.85, 0.93, 0.99])
def test_calibrate_budget_law_joint_identical(target):
    jb, tb = _budgets(l_min=16, l_max=64, lam=0.2, hop_factor=2)
    assert tcal.joint_l_min_candidates(tb) == jcal.joint_l_min_candidates(jb)
    got = tcal.calibrate_budget_law_joint(lambda c: _scripted, tb, target,
                                          max_hop_factor=8)
    want = jcal.calibrate_budget_law_joint(lambda c: _scripted, jb, target,
                                           max_hop_factor=8)
    _same_fit(got, want)


def test_per_class_fits_identical():
    jb, tb = _budgets(l_min=16, l_max=64, lam=0.2, hop_factor=2)
    targets = {"interactive": 0.85, "batch": 0.97}
    got = tcal.calibrate_budget_law_per_class(lambda c: _scripted, tb,
                                              targets)
    want = jcal.calibrate_budget_law_per_class(lambda c: _scripted, jb,
                                               targets)
    assert list(got) == list(want)
    for name in targets:
        _same_fit(got[name], want[name])
    cfgs_t = tcal.class_budget_cfgs(got, tb)
    cfgs_j = jcal.class_budget_cfgs(want, jb)
    assert {k: dataclasses.asdict(v) for k, v in cfgs_t.items()} == {
        k: dataclasses.asdict(v) for k, v in cfgs_j.items()}


@pytest.mark.parametrize("n,sample,seed", [(40, 32, 0), (10000, 256, 0),
                                           (10, 64, 3)])
def test_holdout_sample_same_draw(n, sample, seed):
    np.testing.assert_array_equal(tcal.holdout_sample(n, sample, seed),
                                  jcal.holdout_sample(n, sample, seed))


def test_shape_knobs_guard():
    _, tb = _budgets()
    with pytest.raises(ValueError):
        tcal._check_shape_knobs(dataclasses.replace(tb, l_min=4), tb)
    tcal._check_shape_knobs(dataclasses.replace(tb, lam=0.7, hop_factor=8),
                            tb)


# ----------------------------------------------------------- configs


def test_dataset_configs_match_reference():
    for name, t in tconfigs.DATASETS.items():
        j = next(c for c in jconfigs._DATASETS if c.name == name)
        assert {f.name: getattr(t, f.name) for f in
                dataclasses.fields(t)} == {
            f.name: getattr(j, f.name) for f in dataclasses.fields(t)}
        assert dataclasses.asdict(t.beam_budget()) == dataclasses.asdict(
            j.beam_budget())
    assert len(tconfigs.DATASETS) == len(jconfigs._DATASETS) == 5


def test_dataset_config_joint_fit_uses_its_own_target():
    t = tconfigs.McgiDatasetConfig("t", 1000, 32, 16, 32, None, "float32",
                                   l_search=64, lam=0.3, recall_target=0.9)
    j = jconfigs.McgiDatasetConfig("t", 1000, 32, 16, 32, None, "float32",
                                   l_search=64, lam=0.3, recall_target=0.9)

    def curve(c):
        return 1.0 - 0.2 * c.lam - (0.2 if c.l_min < 8 else 0.0)

    got = t.jointly_calibrated_beam_budget(lambda c: curve)
    want = j.jointly_calibrated_beam_budget(lambda c: curve)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.l_min == 8 and 0.0 < got.lam <= 0.5


# ------------------------------------------------------ recall evaluators


@pytest.mark.parametrize("kind", ["exact", "tiered"])
def test_candidate_grants_from_reference_probe(world, kind):
    """Part one of the adaptive check: the reference's probe LID in, the
    same budgets and hop limits out, for every lam of a bisection and with
    a fixed center."""
    jb, tb = _budgets()
    xi, qi, ti = world["xi"], world["qi"], world["tiered"]
    sel = jcal.holdout_sample(NQ, SAMPLE, 0)
    if kind == "exact":
        _, _, _, q_lid = jsearch._probe_exact_jit(
            jnp.asarray(xi), ti.graph.adj, jnp.asarray(qi[sel]),
            ti.graph.entry, jb)
    else:
        luts = jdisk._query_luts(ti, jnp.asarray(qi[sel]))
        _, _, _, q_lid = jsearch._probe_pq_jit(
            ti.codes, ti.graph.adj, luts, ti.graph.entry, jb)
    for lam in (0.0, 0.25, 0.5, 0.75, 1.0):
        for center in (None, 7.5):
            jc = dataclasses.replace(jb, lam=lam, center=center, hop_factor=4)
            tc = dataclasses.replace(tb, lam=lam, center=center, hop_factor=4)
            want = jcal._candidate_grants(jc, q_lid)
            got = tcal._candidate_grants(tc, torch.tensor(
                np.asarray(q_lid)))
            for a, w in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["exact", "tiered"])
@pytest.mark.parametrize("target", [0.9, 0.95, 0.99])
def test_joint_fit_over_engine_matches_reference(world, kind, target):
    jmake, tmake = _evals(world, kind)
    jb, tb = _budgets()
    want = jcal.calibrate_budget_law_joint(jmake, jb, target)
    got = tcal.calibrate_budget_law_joint(tmake, tb, target)
    _same_fit(got, want)


@pytest.mark.parametrize("kind", ["exact", "tiered"])
def test_lam_fit_over_engine_matches_reference(world, kind):
    jmake, tmake = _evals(world, kind)
    jb, tb = _budgets(l_min=2)
    want = jcal.calibrate_budget_law(jmake(jb), jb, 0.95, max_iters=5)
    got = tcal.calibrate_budget_law(tmake(tb), tb, 0.95, max_iters=5)
    _same_fit(got, want)


# --------------------------------------------------- engine and launcher


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("kind", ["exact", "tiered"])
def test_engine_recalibrate_matches_reference(world, kind, joint):
    xi, qi, gt, ti, port = (world[k] for k in
                            ("xi", "qi", "gt", "tiered", "port"))
    jb, tb = _budgets(l_min=4)
    if kind == "exact":
        jback = jserving.ExactBackend(jnp.asarray(xi), ti.graph.adj,
                                      ti.graph.entry)
        tback = tserving.ExactBackend(port.vectors, port.graph.adj,
                                      port.graph.entry, device="cpu")
    else:
        jback = jserving.TieredBackend(ti)
        tback = tserving.TieredBackend(port, device="cpu")
    jeng = jserving.SearchEngine(jback, jb, k=K)
    teng = tserving.SearchEngine(tback, tb, k=K)
    want = jeng.recalibrate(qi, gt, recall_target=0.95, joint=joint,
                            sample=SAMPLE)
    got = teng.recalibrate(qi, gt, recall_target=0.95, joint=joint,
                           sample=SAMPLE)
    _same_fit(got, want)
    assert dataclasses.asdict(teng.budget_cfg) == dataclasses.asdict(
        jeng.budget_cfg)
    # The fitted law is live: the next search serves with it, as the
    # reference's engine does.
    res_t, res_j = teng.search(qi[:16]), jeng.search(qi[:16])
    np.testing.assert_array_equal(res_t.ids, np.asarray(res_j.ids))


def test_recalibrate_needs_an_adaptive_engine(world):
    port = world["port"]
    eng = tserving.SearchEngine(
        tserving.ExactBackend(port.vectors, port.graph.adj, port.graph.entry,
                              device="cpu"), None, k=K)
    with pytest.raises(ValueError):
        eng.recalibrate(world["qi"], world["gt"])
    _, tb = _budgets()
    eng = tserving.SearchEngine(eng.backend, tb, k=K)
    with pytest.raises(ValueError):
        eng.recalibrate(joint=True)


def test_launcher_calibrates_before_serving(capsys):
    tserve.main(["--device", "cpu", "--n", "1500", "--adaptive",
                 "--calibrate", "--joint", "--backend", "exact",
                 "--degree", "16", "--l-build", "32", "--num-batches", "2",
                 "--calib-sample", "64"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "calibrated" in ln)
    assert "target 0.95" in line and "hit" in line
    assert "recall@10=" in out


@pytest.mark.parametrize("argv", [["--calibrate"],
                                  ["--adaptive", "--joint"]])
def test_launcher_rejects_calibrate_without_adaptive(argv):
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu"] + argv)
