"""The slice end to end: an index the reference built on ``tiny-mixture``,
carried into the port with ``repro_torch.index.convert``, served by both.

* Integer-valued vectors, queries and codebook (the reference's, scaled by
  4 and rounded) make every float32 sum exact: walks, probe states, budgets
  and results must be bit-identical, on both backends and through the
  engine's search, stream, coalescing, filter and partial paths.
* On the float index, distances agree within 1e-4 (relative) wherever the
  two result lists hold the same ids, and recall@10 within 0.01.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.core import build as jbuild  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.types import GraphIndex  # noqa: E402
from repro.index import build_tiered_index  # noqa: E402
from repro.index import disk as jdisk  # noqa: E402
from repro.pq import PqCodebook, build_lut, pq_encode  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.index import convert  # noqa: E402
from repro_torch.index import disk as tdisk  # noqa: E402
from repro_torch.pq import adc as tadc  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
N, NQ, K, BEAM = 500, 24, 10, 24
CFG = jbuild.BuildConfig(degree=12, beam_width=24, iters=1, batch=125,
                         max_hops=48)
BUDGET_KW = dict(l_min=6, l_max=BEAM, lam=0.3, center=7.0)


def _arrays(tiered) -> dict:
    g = tiered.graph
    return {k: np.asarray(v) for k, v in dict(
        adj=g.adj, entry=g.entry, alpha=g.alpha, lid=g.lid, mu=g.mu,
        sigma=g.sigma, centroids=tiered.codebook.centroids,
        codes=tiered.codes, vectors=tiered.vectors).items()}


@pytest.fixture(scope="module")
def world(tiny_dataset):
    x, q = tiny_dataset
    x, q = x[:N], q[:NQ]
    graph = jbuild.build_mcgi(x, CFG)
    tiered = build_tiered_index(x, graph, m_pq=8)
    # The integer twin: same graph, vectors/queries/centroids scaled by 4
    # and rounded, codes re-encoded by the reference with that codebook.
    xi = np.round(np.asarray(x) * 4).astype(np.float32)
    qi = np.round(np.asarray(q) * 4).astype(np.float32)
    book_i = PqCodebook(jnp.round(tiered.codebook.centroids * 4))
    tiered_i = jdisk.TieredIndex(
        graph=GraphIndex(adj=graph.adj, entry=graph.entry, alpha=graph.alpha,
                         lid=graph.lid, mu=graph.mu, sigma=graph.sigma),
        codebook=book_i, codes=pq_encode(jnp.asarray(xi), book_i),
        vectors=jnp.asarray(xi))
    _, gt = jdist.brute_force_topk(q, x, k=K)
    return dict(x=np.asarray(x), q=np.asarray(q), tiered=tiered,
                gt=np.asarray(gt), xi=xi, qi=qi, tiered_i=tiered_i,
                port=convert.tiered_index_from_arrays(_arrays(tiered), "cpu"),
                port_i=convert.tiered_index_from_arrays(_arrays(tiered_i),
                                                        "cpu"))


def _recall(ids, gt):
    return float(np.mean([np.isin(a, b).mean() for a, b in zip(ids, gt)]))


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _engines(world, kind, integer, budget, **kw):
    idx = world["tiered_i" if integer else "tiered"]
    port = world["port_i" if integer else "port"]
    jb = jsearch.AdaptiveBeamBudget(**BUDGET_KW) if budget else None
    tb = tsearch.AdaptiveBeamBudget(**BUDGET_KW) if budget else None
    if kind == "tiered":
        jback = jserving.TieredBackend(idx)
        tback = tserving.TieredBackend(port, device="cpu")
    else:
        jback = jserving.ExactBackend(idx.vectors, idx.graph.adj,
                                      idx.graph.entry)
        tback = tserving.ExactBackend(port.vectors, port.graph.adj,
                                      port.graph.entry, device="cpu")
    common = dict(k=K, beam_width=BEAM, max_hops=64, **kw)
    return (jserving.SearchEngine(jback, jb, **common),
            tserving.SearchEngine(tback, tb, **common))


def test_convert_carries_every_array(world):
    port, tiered = world["port"], world["tiered"]
    _same(port.graph.adj, tiered.graph.adj)
    _same(port.codes, tiered.codes)
    _same(port.codebook.centroids, tiered.codebook.centroids)
    assert int(port.graph.entry) == int(tiered.graph.entry)
    assert port.fast_tier_bytes() == tiered.fast_tier_bytes()


@pytest.mark.parametrize("step_kernel", ["plain", "fused"])
def test_fixed_walks_bit_identical_integer(world, step_kernel):
    """The port's hop loop against both of the reference's hops: its plain
    hop ("reference") and its Pallas kernel in interpret mode ("pallas")."""
    ref_step = {"plain": "reference", "fused": "pallas"}[step_kernel]
    xi, qi, ti, pi = world["xi"], world["qi"], world["tiered_i"], world["port_i"]
    adj, entry = ti.graph.adj, ti.graph.entry
    want = jsearch.beam_search_exact(jnp.asarray(xi), adj, jnp.asarray(qi),
                                     entry, beam_width=BEAM, max_hops=64,
                                     k=BEAM, step_kernel=ref_step)
    got = tsearch.beam_search_exact(pi.vectors, pi.graph.adj, T(qi),
                                    pi.graph.entry, beam_width=BEAM,
                                    max_hops=64, k=BEAM)
    for g, w in zip(got[:2] + (got[2].hops, got[2].dist_evals),
                    want[:2] + (want[2].hops, want[2].dist_evals)):
        _same(g, w)
    jl = build_lut(jnp.asarray(qi), ti.codebook.centroids)
    tl = tadc.build_lut(T(qi), pi.codebook.centroids)
    _same(tl, jl)
    want = jsearch.beam_search_pq(ti.codes, jl, ti.vectors, adj,
                                  jnp.asarray(qi), entry, beam_width=BEAM,
                                  max_hops=64, k=K, step_kernel=ref_step)
    got = tsearch.beam_search_pq(pi.codes, tl, pi.vectors, pi.graph.adj,
                                 T(qi), pi.graph.entry, beam_width=BEAM,
                                 max_hops=64, k=K)
    for g, w in zip(got[:2] + (got[2].hops,), want[:2] + (want[2].hops,)):
        _same(g, w)


@pytest.mark.parametrize("filtered", [False, True])
def test_adaptive_phases_bit_identical_integer(world, filtered):
    """Probe state, grant and continue: the continue phase is fed the
    reference's budgets and hop limits."""
    qi, ti, pi = world["qi"], world["tiered_i"], world["port_i"]
    jcfg = jsearch.AdaptiveBeamBudget(**BUDGET_KW)
    tcfg = tsearch.AdaptiveBeamBudget(**BUDGET_KW)
    allowed = np.random.default_rng(0).random((NQ, N)) < 0.7
    jl = build_lut(jnp.asarray(qi), ti.codebook.centroids)
    tl = T(np.array(jl))
    jex = jsearch.pack_filter(allowed, N) if filtered else None
    tex = (tsearch.pack_filter(allowed, N, device="cpu") if filtered
           else None)
    jst, jb, jh, jq = jsearch._probe_pq_jit(ti.codes, ti.graph.adj, jl,
                                            ti.graph.entry, jcfg, excl=jex)
    tst, tb, th, tq = tsearch._probe_pq(pi.codes, pi.graph.adj, tl,
                                        pi.graph.entry, tcfg, excl=tex)
    for g, w in zip(tst, jst):
        _same(g, w)
    _same(tb, jb)
    _same(th, jh)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5)
    want = jsearch._continue_pq_jit(ti.codes, ti.graph.adj, jst, jl, jb, jh,
                                    jcfg)
    got = tsearch._continue_pq(pi.codes, pi.graph.adj, tst, tl,
                               T(np.array(jb)), T(np.array(jh)), tcfg)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("kind", ["tiered", "exact"])
def test_engine_bit_identical_integer(world, kind):
    """search, the double-buffered stream, coalesced micro-batches and the
    begin/finish_from/partial seam: the port's engine equals the
    reference's engine bit for bit."""
    qi = world["qi"]
    jeng, teng = _engines(world, kind, True, True)
    want = jeng.search(qi)
    got = teng.search(qi)
    for a in ("ids", "d2"):
        _same(getattr(got, a), getattr(want, a))
    _same(got.stats.hops, want.stats.hops)
    _same(got.astats.budget, want.astats.budget)
    assert got.ceilings == want.ceilings
    batches = [qi[:12], qi[12:]]
    jres = list(jeng.search_batches(batches))
    tres = list(teng.search_batches(batches))
    for g, w in zip(tres, jres):
        _same(g.ids, w.ids)
        _same(g.d2, w.d2)
    _, tco = _engines(world, kind, True, True, coalesce_lanes=24)
    merged = list(tco.search_batches(batches))     # one dispatch, split back
    assert [r.ids.shape[0] for r in merged] == [12, 12]
    _same(np.concatenate([r.ids for r in merged]), want.ids)
    f = teng.begin(qi)
    part = teng.partial_result(f)
    jpart = jeng.partial_result(jeng.begin(qi))
    _same(part.ids, jpart.ids)
    assert part.extras["partial"]
    full = teng.finish_from(f)
    _same(full.ids, want.ids)


@pytest.mark.parametrize("kind", ["tiered", "exact"])
def test_engine_filter_integer(world, kind):
    """A per-query allowed mask is enforced in-graph: nothing out of filter
    comes back, results equal the reference's, and an all-True mask equals
    the unfiltered search."""
    qi = world["qi"]
    allowed = np.random.default_rng(1).random((NQ, N)) < 0.5
    jeng, teng = _engines(world, kind, True, True)
    got, want = teng.search(qi, filter=allowed), jeng.search(qi,
                                                             filter=allowed)
    _same(got.ids, want.ids)
    ids = got.ids
    ok = allowed[np.arange(NQ)[:, None], np.maximum(ids, 0)] | (ids < 0)
    assert ok.all()
    everything = teng.search(qi, filter=np.ones(N, bool))
    _same(everything.ids, teng.search(qi).ids)
    jfix, tfix = _engines(world, kind, True, False)
    _same(tfix.search(qi, filter=allowed).ids,
          jfix.search(qi, filter=allowed).ids)


@pytest.mark.parametrize("kind", ["tiered", "exact"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_engine_float_within_tolerance(world, kind, adaptive):
    """Float data: recall@10 within 0.01 of the reference; distances within
    1e-4 wherever both return the same ids."""
    q, gt = world["q"], world["gt"]
    jeng, teng = _engines(world, kind, False, adaptive)
    want = jeng.search(q)
    got = list(teng.search_batches([q[:12], q[12:]]))
    ids = np.concatenate([r.ids for r in got])
    d2 = np.concatenate([r.d2 for r in got])
    jstream = list(jeng.search_batches([q[:12], q[12:]]))
    jids = np.concatenate([r.ids for r in jstream])
    jd2 = np.concatenate([r.d2 for r in jstream])
    assert abs(_recall(ids, gt) - _recall(jids, gt)) <= 0.01
    same = (ids == jids).all(1)
    assert same.mean() >= 0.9
    np.testing.assert_allclose(d2[same], jd2[same], rtol=1e-4)
    assert _recall(want.ids, gt) > 0.8


def test_bucketed_entry_points_equal_unbucketed(world):
    """num_buckets= schedules the continue phase per bucket without changing
    a single result (port-only property)."""
    qi, pi = T(world["qi"]), world["port_i"]
    cfg = tsearch.AdaptiveBeamBudget(**BUDGET_KW)
    one = tdisk.search_tiered_adaptive(pi, qi, cfg, k=K)
    four = tdisk.search_tiered_adaptive(pi, qi, cfg, k=K, num_buckets=4)
    for a, b in zip(one[:2], four[:2]):
        assert torch.equal(a, b)
    ex = functools.partial(tsearch.beam_search_exact_adaptive, pi.vectors,
                           pi.graph.adj, qi, pi.graph.entry, cfg, k=K)
    assert torch.equal(ex()[0], ex(num_buckets=3)[0])
