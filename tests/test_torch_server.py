"""The port's serving front door (``repro_torch.serving.server``).

* Every test of the reference's ``tests/test_server.py`` on the port's
  engines (an index the port builds on the CPU; a pinned LID center, so a
  lane's result does not depend on its dispatch's other lanes), under the
  virtual clock; the admission mechanics against a deterministic fake
  engine.
* A cross-package replay: one seeded arrival script through the
  reference's ``FrontDoor`` over the reference's engine and through the
  port's over the same index carried across with
  ``repro_torch.index.convert`` (integer data, constant service and probe
  times): status, ``t_done``, ids, d2, hops and budget equal per request.
* The engine seam the door drives: a backend swap between ``begin`` and
  ``finish_from``, the probe walk's convergence check read where the flight
  is first read on the host, a wall-clock door at two workers (every wait
  bounded), and, on the card, ``begin`` without a host sync and a partial
  that completes before its flight's continue.
* The launcher's ``--serve``, its argument checks, and ``--vamana``.

The reference is imported in fixtures only, so that the file's ``gpu``
test runs on the card without JAX.
"""
import ast
import dataclasses
import functools
import math
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.index import build_tiered_index, convert  # noqa: E402
from repro_torch.index import disk as tdisk  # noqa: E402
from repro_torch.index import load_index  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import server  # noqa: E402
from repro_torch.serving.engine import BatchResult  # noqa: E402

torch.set_num_threads(1)
N, D, NQ, K = 600, 16, 40, 10
CFG = tbuild.BuildConfig(degree=16, beam_width=32, iters=1, batch=128,
                         max_hops=64)
# Pinned LID center: with batch-mean centering a lane's budget depends on
# which queries share its dispatch (the reducer's property).
BUDGET = tsearch.AdaptiveBeamBudget(l_min=8, l_max=32, lam=0.3, center=8.0)
SLEEP_CYCLES = 100_000_000          # ~50 ms of the card


@functools.lru_cache(maxsize=None)
def _world(device: str = "cpu"):
    """(x, q, graph, tiered): a seeded corpus and the port's own index."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    graph = tbuild.build_mcgi(x, CFG, device=device)
    return x, q, graph, build_tiered_index(x, graph, m_pq=4, device=device)


def _engine(kind: str = "exact", budget=BUDGET, device: str = "cpu"):
    x, _q, graph, tiered = _world(device)
    if kind == "exact":
        backend = tserving.ExactBackend(x, graph.adj, graph.entry,
                                        device=device)
    else:
        backend = tserving.TieredBackend(tiered, device=device)
    return tserving.SearchEngine(backend, budget, k=K)


@functools.lru_cache(maxsize=1)
def ref_rows():
    """Per-lane results over the queries: under the pinned center, row i of
    the all-queries batch equals lane i of any dispatch holding it."""
    q = _world()[1]
    res = _engine("exact").search(q)
    return q, res.ids, res.d2


class FakeEngine:
    """Deterministic engine-shaped object for admission mechanics: results
    derived from the batch bytes, injectable finish failure, close counting.
    No partial support: in-flight deadline hedges fall through to timeout."""

    supports_partial = False

    def __init__(self, k: int = 4, fail_finish: bool = False):
        self.k = k
        self.fail_finish = fail_finish
        self.close_calls = 0
        self.finishes = 0

    def begin(self, batch):
        return {"batch": np.asarray(batch, np.float64)}

    def finish_from(self, flight):
        if self.fail_finish:
            raise RuntimeError("injected finish failure")
        self.finishes += 1
        b = flight["batch"]
        base = np.round(b[:, :1] * 1000.0).astype(np.int64)
        ids = base + np.arange(self.k)[None, :]
        d2 = ids.astype(np.float64) / 7.0
        stats = tsearch.SearchStats(hops=np.full(b.shape[0], 7.0),
                                    dist_evals=np.full(b.shape[0], 70.0))
        return BatchResult(ids=ids, d2=d2, stats=stats)

    def close(self):
        self.close_calls += 1


def fake_door(*, deadline_s=100.0, batch_window_s=0.0, max_lanes=4,
              max_queue=256, service_time=0.0, probe_time=0.0, eng=None,
              lane_quantum=1):
    clock = server.VirtualClock()
    eng = FakeEngine() if eng is None else eng
    door = server.FrontDoor(
        {"a": eng},
        [server.QoSClass("a", deadline_s=deadline_s,
                         batch_window_s=batch_window_s, max_lanes=max_lanes,
                         lane_quantum=lane_quantum)],
        max_queue=max_queue, clock=clock,
        dispatcher=server.VirtualDispatcher(
            clock, service_time=service_time, probe_time=probe_time))
    return door, clock, eng


# ------------------------------------------------------------ virtual clock


def test_virtual_clock_orders_by_time_then_submission():
    clock = server.VirtualClock()
    fired = []
    clock.call_at(2.0, fired.append, "late")
    clock.call_at(1.0, fired.append, "first-at-1")
    clock.call_at(1.0, fired.append, "second-at-1")
    t = clock.call_at(1.5, fired.append, "cancelled")
    t.cancel()
    assert clock.pending() == 3
    ran = clock.advance(1.2)
    assert ran == 2 and fired == ["first-at-1", "second-at-1"]
    assert clock.now() == 1.2
    clock.advance(1.0)
    assert fired == ["first-at-1", "second-at-1", "late"]
    t_inf = clock.call_at(math.inf, fired.append, "never")
    clock.advance(1e9)
    assert fired[-1] == "late" and not t_inf.cancelled


def test_virtual_clock_callbacks_see_their_own_fire_time():
    clock = server.VirtualClock()
    seen = []
    clock.call_at(1.0, lambda: (seen.append(clock.now()),
                                clock.call_later(0.5, seen.append, "chain")))
    clock.advance(2.0)
    assert seen == [1.0, "chain"]


# ------------------------------------- bit-identity of admitted results


@pytest.mark.parametrize("seed", range(8))
def test_served_results_bit_identical_to_direct(seed):
    """Randomized arrivals, class mixes and coalescing boundaries (drawn
    from ``seed``): every admitted request's served lane is bit-identical
    to the direct engine result for that query."""
    q, ref_ids, ref_d2 = ref_rows()
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 15))
    max_lanes = int(rng.choice([1, 2, 3, 5]))
    window = float(rng.choice([0.0, 0.01, 0.05]))
    two_classes = bool(rng.integers(2))
    eng = _engine("exact")
    clock = server.VirtualClock()
    classes = [server.QoSClass("a", deadline_s=1e6, batch_window_s=window,
                               max_lanes=max_lanes)]
    engines = {"a": eng}
    if two_classes:
        classes.append(server.QoSClass("b", deadline_s=1e6,
                                       batch_window_s=window,
                                       max_lanes=max_lanes))
        engines["b"] = eng
    door = server.FrontDoor(engines, classes, clock=clock,
                            dispatcher=server.VirtualDispatcher(clock))
    rows = rng.integers(0, q.shape[0], size=n)
    names = [c.name for c in classes]
    futs = []
    for r in rows:
        futs.append(door.submit(q[r], cls=names[rng.integers(len(names))]))
        clock.advance(float(rng.choice([0.0, 0.002, 0.02])))
    clock.advance(1.0)
    for r, f in zip(rows, futs):
        res = f.result(timeout=0)
        assert res.status == server.OK, res
        np.testing.assert_array_equal(res.ids, ref_ids[r])
        np.testing.assert_array_equal(res.d2, ref_d2[r])
    stats = door.stats()
    assert stats["admitted"] == n and stats["ok"] == n
    assert stats["open_lanes"] == 0 and stats["queued_lanes"] == 0


def test_lane_quantum_padding_is_result_transparent():
    q, ref_ids, ref_d2 = ref_rows()
    clock = server.VirtualClock()
    door = server.FrontDoor(
        {"a": _engine("exact")},
        [server.QoSClass("a", deadline_s=1e6, batch_window_s=0.01,
                         max_lanes=8, lane_quantum=4)],
        clock=clock, dispatcher=server.VirtualDispatcher(clock))
    futs = [door.submit(q[i]) for i in range(6)]     # 6 lanes -> pad to 8
    clock.advance(0.02)
    for i, f in enumerate(futs):
        res = f.result(timeout=0)
        assert res.status == server.OK
        np.testing.assert_array_equal(res.ids, ref_ids[i])
        np.testing.assert_array_equal(res.d2, ref_d2[i])
    assert door.stats()["dispatches"] == 1


# --------------------------------------------- deadlines, hedges, partials


@pytest.mark.parametrize("kind", ["exact", "tiered"])
def test_deadline_hedge_partial_matches_engine_partial(kind):
    """A deadline expiring mid-flight serves the best-so-far partial,
    bit-identical to ``engine.partial_result`` of an identical dispatch;
    the late full result never overwrites it."""
    q = ref_rows()[0]
    eng = _engine(kind)
    assert eng.supports_partial
    clock = server.VirtualClock()
    door = server.FrontDoor(
        {"a": eng}, [server.QoSClass("a", deadline_s=1.0, max_lanes=3)],
        clock=clock,
        dispatcher=server.VirtualDispatcher(clock, service_time=10.0,
                                            probe_time=0.001))
    futs = [door.submit(q[i]) for i in range(3)]     # flush at max_lanes
    ref = eng.partial_result(eng.begin(q[:3]))
    clock.advance(1.0)
    for i, f in enumerate(futs):
        res = f.result(timeout=0)
        assert res.status == server.PARTIAL
        np.testing.assert_array_equal(res.ids, ref.ids[i])
        np.testing.assert_array_equal(res.d2, ref.d2[i])
        assert res.extras.get("partial") is True
    clock.advance(20.0)
    assert all(f.result(timeout=0).status == server.PARTIAL for f in futs)
    stats = door.stats()
    assert stats["partial"] == 3 and stats["open_lanes"] == 0


def test_deadline_in_queue_times_out_and_frees_slot():
    door, clock, _ = fake_door(deadline_s=0.5, batch_window_s=10.0,
                               max_lanes=8)
    futs = [door.submit(np.float64([i, 0.0])) for i in range(2)]
    assert door.stats()["queued_lanes"] == 2
    clock.advance(0.5)
    assert [f.result(timeout=0).status for f in futs] == [server.TIMEOUT] * 2
    stats = door.stats()
    assert stats["queued_lanes"] == 0 and stats["open_lanes"] == 0
    f = door.submit(np.float64([5.0, 0.0]), deadline_s=20.0)
    clock.advance(10.0)
    assert f.result(timeout=0).status == server.OK


def test_wedged_dispatch_without_probe_times_out():
    door, clock, _ = fake_door(deadline_s=1.0, max_lanes=2,
                               service_time=math.inf, probe_time=math.inf)
    futs = [door.submit(np.float64([i, 0.0])) for i in range(4)]
    clock.advance(1.0)
    assert all(f.result(timeout=0).status == server.TIMEOUT for f in futs)
    assert door.stats()["open_lanes"] == 0


def test_overload_sheds_at_bound_and_hedges_reopen_admission():
    door, clock, _ = fake_door(deadline_s=1.0, max_lanes=2, max_queue=6,
                               service_time=math.inf, probe_time=math.inf)
    futs = [door.submit(np.float64([i, 0.0])) for i in range(15)]
    stats = door.stats()
    assert stats["shed"] == 9 and stats["max_open_lanes"] == 6
    shed = [f.result(timeout=0) for f in futs if f.done()]
    assert len(shed) == 9 and all("queue full" in r.note for r in shed)
    clock.advance(1.0)
    assert all(f.done() for f in futs)
    stats = door.stats()
    assert stats["timeout"] == 6 and stats["open_lanes"] == 0
    f = door.submit(np.float64([99.0, 0.0]))
    assert not f.done() or f.result(timeout=0).status != server.SHED
    clock.advance(2.0)
    assert f.result(timeout=0).status == server.TIMEOUT
    assert door.stats()["max_open_lanes"] <= 6


def test_dispatch_error_surfaces_as_error_status():
    door, clock, _ = fake_door(eng=FakeEngine(fail_finish=True), max_lanes=2)
    futs = [door.submit(np.float64([i, 0.0])) for i in range(2)]
    clock.advance(0.1)
    for f in futs:
        res = f.result(timeout=0)
        assert res.status == server.ERROR
        assert "injected finish failure" in res.note
    assert door.stats()["error"] == 2 and door.stats()["open_lanes"] == 0


# ----------------------------------------------------- shutdown / lifecycle


def test_drain_serves_pending_and_closes_shared_engine_once():
    eng = FakeEngine()
    clock = server.VirtualClock()
    door = server.FrontDoor(
        {"a": eng, "b": eng},
        [server.QoSClass("a", deadline_s=100.0, batch_window_s=50.0,
                         max_lanes=8),
         server.QoSClass("b", deadline_s=100.0, batch_window_s=50.0,
                         max_lanes=8)],
        clock=clock, dispatcher=server.VirtualDispatcher(clock))
    futs = [door.submit(np.float64([i, 0.0]), cls="a") for i in range(3)]
    futs += [door.submit(np.float64([9.0, 0.0]), cls="b")]
    assert not any(f.done() for f in futs)
    server.drain_virtual(door, clock)
    assert door.drained
    assert all(f.result(timeout=0).status == server.OK for f in futs)
    assert eng.close_calls == 1
    res = door.submit(np.float64([0.0, 0.0]), cls="a").result(timeout=0)
    assert res.status == server.SHED and "closing" in res.note
    door.close(wait=False)
    assert eng.close_calls == 1
    stats = door.stats()
    assert stats["ok"] == 4 and stats["shed"] == 1
    assert stats["admitted"] == stats["ok"]


def test_drain_completes_wedged_lanes_via_deadlines():
    door, clock, eng = fake_door(deadline_s=2.0, max_lanes=2,
                                 service_time=math.inf, probe_time=math.inf)
    futs = [door.submit(np.float64([i, 0.0])) for i in range(4)]
    server.drain_virtual(door, clock)
    assert door.drained
    assert all(f.result(timeout=0).status == server.TIMEOUT for f in futs)
    assert eng.close_calls == 1


def test_engine_close_idempotent_and_safe_with_inflight_stream(tmp_path):
    """``SearchEngine.close()`` while a ``search_batches`` stream over a
    disk tier is in flight: the stream completes bit-identically and a
    second close is a no-op (events only, no sleeps)."""
    _x, q, _g, tiered = _world()
    tier = tdisk.open_or_build_slow_tier(tmp_path / "s.blocks", tiered,
                                         cache_nodes=256, pin_nodes=0)
    eng = tserving.SearchEngine(
        tserving.TieredBackend(tiered, slow_tier=tier, device="cpu"),
        BUDGET, k=K)
    batches = [q[:8], q[8:20], q[20:32]]
    ref = [eng.search(b) for b in batches]
    first_done, closed = threading.Event(), threading.Event()
    out = []

    def stream():
        yield batches[0]
        first_done.set()
        assert closed.wait(60), "close() never signalled"
        yield batches[1]
        yield batches[2]

    t = threading.Thread(
        target=lambda: out.extend(eng.search_batches(stream())))
    t.start()
    assert first_done.wait(60)
    eng.close()
    eng.close()
    closed.set()
    t.join(timeout=120)
    assert not t.is_alive() and len(out) == 3
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.d2, want.d2)


# ------------------------------------------------ determinism / QoS classes


def _replay_run(seed: int):
    """One randomized front-door scenario; returns a serializable trace."""
    q = ref_rows()[0]
    rng = np.random.default_rng(seed)
    eng = _engine("exact")
    clock = server.VirtualClock()
    door = server.FrontDoor(
        {"a": eng, "b": eng},
        [server.QoSClass("a", deadline_s=0.25, batch_window_s=0.02,
                         max_lanes=3),
         server.QoSClass("b", deadline_s=5.0, batch_window_s=0.1,
                         max_lanes=5)],
        max_queue=8, clock=clock,
        dispatcher=server.VirtualDispatcher(clock, service_time=0.3,
                                            probe_time=0.01))
    futs = []
    for _ in range(12):
        r = int(rng.integers(0, q.shape[0]))
        cls = "a" if rng.random() < 0.5 else "b"
        futs.append(door.submit(q[r], cls=cls))
        clock.advance(float(rng.choice([0.0, 0.01, 0.15])))
    clock.advance(30.0)
    trace = []
    for f in futs:
        res = f.result(timeout=0)
        trace.append((res.status, res.qos, round(res.latency, 9),
                      None if res.ids is None else res.ids.tobytes()))
    return trace, door.stats()


def test_identical_runs_replay_bit_exactly():
    t1, s1 = _replay_run(1234)
    t2, s2 = _replay_run(1234)
    assert t1 == t2 and s1 == s2
    assert server.OK in {s for s, _, _, _ in t1}


def test_per_class_budget_laws_diverge_over_shared_backend():
    """Two QoS classes with their own (lam, l_min) engines over one shared
    backend: the thorough class is granted more budget for the same
    queries."""
    q = ref_rows()[0]
    eng_i = _engine("exact")
    eng_b = tserving.SearchEngine(
        eng_i.backend, dataclasses.replace(BUDGET, l_min=BUDGET.l_max), k=K)
    clock = server.VirtualClock()
    door = server.FrontDoor(
        {"interactive": eng_i, "batch": eng_b},
        [server.QoSClass("interactive", deadline_s=1e6, max_lanes=8),
         server.QoSClass("batch", deadline_s=1e6, max_lanes=8)],
        clock=clock, dispatcher=server.VirtualDispatcher(clock))
    fi = [door.submit(q[i], cls="interactive") for i in range(8)]
    fb = [door.submit(q[i], cls="batch") for i in range(8)]
    clock.advance(1.0)
    bud_i = [f.result(timeout=0).budget for f in fi]
    bud_b = [f.result(timeout=0).budget for f in fb]
    assert all(b is not None for b in bud_i + bud_b)
    assert np.mean(bud_b) > np.mean(bud_i)
    assert max(bud_i) <= BUDGET.l_max and min(bud_b) == BUDGET.l_max


def test_calibrate_budget_law_per_class():
    def make_eval(cfg):
        def eval_recall(c):
            return min(1.0, 1.0 - 0.5 * c.lam + 0.001 * c.l_min)
        return eval_recall

    results = tcal.calibrate_budget_law_per_class(
        make_eval, BUDGET, {"interactive": 0.7, "batch": 0.95}, joint=False)
    assert set(results) == {"interactive", "batch"}
    assert all(r.achieved for r in results.values())
    assert results["interactive"].lam > results["batch"].lam
    cfgs = tcal.class_budget_cfgs(results, BUDGET)
    assert set(cfgs) == {"interactive", "batch"}
    for name, cfg in cfgs.items():
        assert cfg.lam == results[name].lam and cfg.l_max == BUDGET.l_max


# ---------------------------------------------- the reference, side by side


@pytest.fixture(scope="module")
def J():
    """The reference, imported here so that the file loads without JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import serving
    from repro.core import build, search
    from repro.core.types import GraphIndex
    from repro.index import build_tiered_index as jbuild_tiered
    from repro.index import disk
    from repro.pq import PqCodebook, pq_encode
    from repro.serving import server as jserver

    return types.SimpleNamespace(
        jnp=jnp, serving=serving, build=build, search=search,
        GraphIndex=GraphIndex, build_tiered_index=jbuild_tiered, disk=disk,
        PqCodebook=PqCodebook, pq_encode=pq_encode, server=jserver)


@pytest.fixture(scope="module")
def integer_pair(J):
    """The reference's index on integer vectors with an integer codebook
    (codes re-encoded with it), and the port's copy of it."""
    rng = np.random.default_rng(5)
    x = rng.integers(-20, 21, (500, D)).astype(np.float32)
    q = rng.integers(-20, 21, (NQ, D)).astype(np.float32)
    cfg = J.build.BuildConfig(degree=12, beam_width=24, iters=1, batch=125,
                              max_hops=48)
    graph = J.build.build_mcgi(J.jnp.asarray(x), cfg)
    tiered = J.build_tiered_index(J.jnp.asarray(x), graph, m_pq=4)
    book = J.PqCodebook(J.jnp.round(tiered.codebook.centroids))
    ti = J.disk.TieredIndex(
        graph=J.GraphIndex(adj=graph.adj, entry=graph.entry,
                           alpha=graph.alpha, lid=graph.lid, mu=graph.mu,
                           sigma=graph.sigma),
        codebook=book, codes=J.pq_encode(J.jnp.asarray(x), book),
        vectors=J.jnp.asarray(x))
    g = ti.graph
    arrays = {k: np.asarray(v) for k, v in dict(
        adj=g.adj, entry=g.entry, alpha=g.alpha, lid=g.lid, mu=g.mu,
        sigma=g.sigma, centroids=ti.codebook.centroids, codes=ti.codes,
        vectors=ti.vectors).items()}
    return q, ti, convert.tiered_index_from_arrays(arrays, "cpu")


def _scripted_run(sv, engines, q, seed: int):
    """One seeded arrival script through a front door of module ``sv``:
    two classes (the first padded to a lane grid), a bound of 8 open lanes
    (sheds), deadlines that hedge the first class mid-flight."""
    rng = np.random.default_rng(seed)
    clock = sv.VirtualClock()
    door = sv.FrontDoor(
        engines,
        [sv.QoSClass("a", deadline_s=0.25, batch_window_s=0.02, max_lanes=3,
                     lane_quantum=4),
         sv.QoSClass("b", deadline_s=5.0, batch_window_s=0.1, max_lanes=5)],
        max_queue=8, clock=clock,
        dispatcher=sv.VirtualDispatcher(clock, service_time=0.3,
                                        probe_time=0.01))
    futs = []
    for _ in range(40):
        r = int(rng.integers(0, q.shape[0]))
        cls = "a" if rng.random() < 0.5 else "b"
        futs.append(door.submit(q[r], cls=cls))
        clock.advance(float(rng.choice([0.0, 0.01, 0.15])))
    sv.drain_virtual(door, clock)
    return [f.result(timeout=0) for f in futs], door.stats()


@pytest.mark.parametrize("kind", ["tiered", "exact"])
def test_front_door_replay_equals_reference_integer(J, integer_pair, kind):
    """The same seeded script through both packages' doors: per request
    the same status, completion time, ids, d2, hops and budget."""
    q, ti, port = integer_pair
    kw = dict(l_min=6, l_max=24, lam=0.3, center=7.0)
    laws = {"a": kw, "b": dict(kw, l_min=kw["l_max"])}
    if kind == "tiered":
        jback = J.serving.TieredBackend(ti)
        tback = tserving.TieredBackend(port, device="cpu")
    else:
        jback = J.serving.ExactBackend(ti.vectors, ti.graph.adj,
                                       ti.graph.entry)
        tback = tserving.ExactBackend(port.vectors, port.graph.adj,
                                      port.graph.entry, device="cpu")
    jengines = {c: J.serving.SearchEngine(
        jback, J.search.AdaptiveBeamBudget(**law), k=K)
        for c, law in laws.items()}
    tengines = {c: tserving.SearchEngine(
        tback, tsearch.AdaptiveBeamBudget(**law), k=K)
        for c, law in laws.items()}
    want, jstats = _scripted_run(J.server, jengines, q, 7)
    got, tstats = _scripted_run(server, tengines, q, 7)
    assert tstats == jstats
    statuses = {r.status for r in want}
    assert {server.OK, server.PARTIAL, server.SHED} <= statuses
    for g, w in zip(got, want):
        assert (g.status, g.qos, g.t_arrival, g.t_done) == (
            w.status, w.qos, w.t_arrival, w.t_done)
        assert (g.hops, g.budget) == (w.hops, w.budget)
        if w.ids is None:
            assert g.ids is None
        else:
            np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
            np.testing.assert_array_equal(g.d2, np.asarray(w.d2))


# ------------------------------------------------- the engine seam, threads


def test_backend_swap_between_begin_and_finish():
    """Lanes whose flight began before ``update_backend`` are answered from
    the old index, lanes admitted after it from the new one: each flight's
    ``finish_from`` is held until both have begun (production seams, every
    wait bounded)."""
    x, q, graph, _t = _world()
    eng = _engine("exact")
    new = tserving.SearchEngine(
        tserving.ExactBackend(2 * x, graph.adj, graph.entry, device="cpu"),
        BUDGET, k=K)
    begun, release = threading.Semaphore(0), threading.Event()
    real_begin, real_finish = eng.begin, eng.finish_from

    def begin(batch, **kw):
        f = real_begin(batch, **kw)
        begun.release()
        return f

    def finish_from(f):
        assert release.wait(60)
        return real_finish(f)

    eng.begin, eng.finish_from = begin, finish_from
    door = server.FrontDoor(
        {"a": eng}, [server.QoSClass("a", deadline_s=600.0, max_lanes=4)],
        dispatcher=server.ThreadDispatcher(workers=2))
    old_futs = [door.submit(q[i]) for i in range(4)]
    assert begun.acquire(timeout=60)                     # begun, held
    eng.update_backend(2 * x, graph.adj, graph.entry)
    new_futs = [door.submit(q[i]) for i in range(4, 8)]
    assert begun.acquire(timeout=60)
    release.set()
    door.close(wait=True, timeout=120)
    want_old, want_new = ref_rows()[2][:8], new.search(q[:8]).d2
    for i, f in enumerate(old_futs):
        np.testing.assert_array_equal(f.result(timeout=0).d2, want_old[i])
    for i, f in enumerate(new_futs, start=4):
        np.testing.assert_array_equal(f.result(timeout=0).d2, want_new[i])
    assert not np.array_equal(want_old[4:8], want_new[4:8])


class SlowBeginEngine(FakeEngine):
    """A fake engine whose ``begin`` waits for ``release``."""

    def __init__(self):
        super().__init__()
        self.entered, self.release = threading.Event(), threading.Event()

    def begin(self, batch):
        self.entered.set()
        assert self.release.wait(60)
        return super().begin(batch)


def test_begin_runs_off_the_submitting_thread():
    """A ``begin`` busy on the dispatcher's begin thread holds neither the
    submitting thread nor the door's lock: submits into either class
    return at once, and every lane completes once it is released."""
    slow, fast = SlowBeginEngine(), FakeEngine()
    door = server.FrontDoor(
        {"a": slow, "b": fast},
        [server.QoSClass("a", deadline_s=600.0, max_lanes=1),
         server.QoSClass("b", deadline_s=600.0, max_lanes=1)],
        dispatcher=server.ThreadDispatcher(workers=2))
    first = door.submit(np.float64([1.0, 0.0]), cls="a")
    assert slow.entered.wait(60)                     # begin is blocked
    later = [door.submit(np.float64([2.0, 0.0]), cls="b"),
             door.submit(np.float64([3.0, 0.0]), cls="a")]
    assert door.stats()["dispatches"] == 3
    assert not any(f.done() for f in [first] + later)
    slow.release.set()
    door.close(wait=True, timeout=60)
    assert [f.result(timeout=0).status for f in [first] + later] == (
        [server.OK] * 3)


class _Relay:
    """A dispatcher over another that forwards every call, as a recording
    wrapper does."""

    def __init__(self, inner):
        self.inner = inner

    def launch(self, fly):
        self.inner.launch(fly)

    def submit(self, disp, finish, on_done):
        self.inner.submit(disp, finish, on_done)

    def close(self):
        self.inner.close()


class _NoLaunch(_Relay):
    launch = None


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrapped"])
def test_begin_runs_on_the_begin_thread(wrap):
    """Through ``ThreadDispatcher``, alone or behind a forwarding wrapper,
    every ``begin`` runs on the dispatcher's begin thread."""
    names = []

    class Named(FakeEngine):
        def begin(self, batch):
            names.append(threading.current_thread().name)
            return super().begin(batch)

    disp = server.ThreadDispatcher(workers=2)
    door = server.FrontDoor(
        {"a": Named()}, [server.QoSClass("a", deadline_s=600.0, max_lanes=1)],
        dispatcher=_Relay(disp) if wrap else disp)
    futs = [door.submit(np.float64([i, 0.0])) for i in range(4)]
    door.close(wait=True, timeout=60)
    disp.close()
    assert [f.result(timeout=0).status for f in futs] == [server.OK] * 4
    assert len(names) == 4
    assert all(n.startswith("front-door-begin") for n in names), names


def test_door_refuses_a_dispatcher_without_launch():
    """A dispatcher that cannot say where ``begin`` runs is refused when the
    door is built, not taken for an inline one."""
    with pytest.raises(TypeError, match="launch"):
        server.FrontDoor({"a": FakeEngine()},
                         [server.QoSClass("a", deadline_s=1.0)],
                         clock=server.VirtualClock(),
                         dispatcher=_NoLaunch(server.ThreadDispatcher()))


def test_dead_dispatch_is_not_begun():
    """A dispatch whose lanes all timed out while it waited for the begin
    thread is completed without a ``begin``."""
    slow = SlowBeginEngine()
    door = server.FrontDoor(
        {"a": slow}, [server.QoSClass("a", deadline_s=0.05, max_lanes=1)],
        dispatcher=server.ThreadDispatcher(workers=1))
    first = door.submit(np.float64([1.0, 0.0]))
    assert slow.entered.wait(60)
    second = door.submit(np.float64([2.0, 0.0]))     # waits for its turn
    assert second.result(timeout=60).status == server.TIMEOUT
    slow.entered.clear()
    slow.release.set()
    door.close(wait=True, timeout=60)
    assert first.result(timeout=0).status == server.TIMEOUT
    assert not slow.entered.is_set()                 # never begun


def test_probe_convergence_check_moves_to_the_first_host_read(monkeypatch):
    """``begin`` leaves the probe walk's counter unread; ``partial_result``,
    ``finish_from`` and ``search`` read it and raise as ``run_batch`` does,
    and every other caller of ``run_batch`` still raises at once."""
    q = ref_rows()[0][:4]
    real = ops.beam_walk

    def stuck(*args, active_count=None, **kw):
        out = real(*args, active_count=active_count, **kw)
        if active_count is not None:
            active_count += 1
        return out

    monkeypatch.setattr(ops, "beam_walk", stuck)
    for kind in ("exact", "tiered"):
        eng = _engine(kind)
        f = eng.begin(q)
        with pytest.raises(RuntimeError, match="could still move"):
            eng.partial_result(f)
        with pytest.raises(RuntimeError, match="could still move"):
            eng.finish_from(f)
        with pytest.raises(RuntimeError, match="could still move"):
            eng.search(q)
    x, _q, graph, _t = _world()
    with pytest.raises(RuntimeError, match="could still move"):
        tsearch._probe_exact(torch.from_numpy(x), graph.adj,
                             torch.from_numpy(q), graph.entry, BUDGET)


def test_wall_clock_door_under_thread_switches():
    """The production seams (``WallClock`` + ``ThreadDispatcher`` at two
    workers) fed by four submitting threads with a short switch interval:
    every future completes once, the counters add up, served lanes equal
    the direct results, and both engines close once.  Every wait is
    bounded."""
    q, ref_ids, ref_d2 = ref_rows()
    eng_a, eng_b = _engine("exact"), _engine("exact")
    closes = []
    for e in (eng_a, eng_b):
        e.close = functools.partial(closes.append, e)
    door = server.FrontDoor(
        {"a": eng_a, "b": eng_b},
        [server.QoSClass("a", deadline_s=600.0, batch_window_s=0.002,
                         max_lanes=4, lane_quantum=4),
         server.QoSClass("b", deadline_s=600.0, batch_window_s=0.01,
                         max_lanes=8)],
        max_queue=64, dispatcher=server.ThreadDispatcher(workers=2))
    futs = [[] for _ in range(4)]

    def submitter(t: int):
        for j in range(10):
            r = (7 * t + 3 * j) % NQ
            futs[t].append((r, door.submit(q[r], cls="ab"[j % 2])))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        door.close(wait=True, timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert door.drained and len(closes) == 2
    stats = door.stats()
    assert stats["submitted"] == 40 == stats["admitted"] + stats["shed"]
    assert stats["ok"] == stats["admitted"] and stats["open_lanes"] == 0
    for r, f in (p for fs in futs for p in fs):
        res = f.result(timeout=0)
        if res.status == server.OK:
            np.testing.assert_array_equal(res.ids, ref_ids[r])
            np.testing.assert_array_equal(res.d2, ref_d2[r])


def test_launch_counts_lose_nothing_under_thread_switches():
    counts = {"x": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count(counts, "x") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["x"] == 16000


# ---------------------------------------------------------------- launcher

TINY = ["--device", "cpu", "--n", "300", "--degree", "12", "--l-build", "24",
        "--build-batch", "128"]


def test_launcher_serve_counts_add_up(capsys):
    tserve.main(TINY + ["--adaptive", "--serve", "--requests", "48",
                        "--qps", "400", "--deadline-ms", "60000",
                        "--batch-deadline-ms", "60000"])
    out = capsys.readouterr().out
    counts = {}
    for line in out.splitlines():
        if line.startswith("[serve] class "):
            name, rest = line[len("[serve] class "):].split(": ", 1)
            counts[name] = ast.literal_eval(rest[:rest.index("}") + 1])
    assert set(counts) == {"interactive", "batch"}
    assert sum(sum(c.values()) for c in counts.values()) == 48
    assert all(set(c) == {"ok"} for c in counts.values())
    assert "[serve] admission: submitted=48 admitted=48 shed=0" in out


@pytest.mark.parametrize("argv", [
    ["--serve"],
    ["--adaptive", "--serve", "--pipeline"],
    ["--adaptive", "--serve", "--filter-frac", "0.5"],
    ["--filter-frac", "0"],
])
def test_launcher_rejects_serve_misuse(argv):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--device", "cpu"] + argv)
    assert e.value.code == 2


def test_launcher_vamana_builds_the_baseline(tmp_path):
    path = tmp_path / "v.npz"
    tserve.main(TINY + ["--vamana", "--index", str(path), "--batch", "8",
                        "--num-batches", "1"])
    x, _q = make_dataset("tiny-mixture", seed=0, device="cpu", n=300)
    want = tbuild.build_vamana(x, 1.2, tbuild.BuildConfig(
        degree=12, beam_width=24, batch=128), device="cpu")
    assert torch.equal(load_index(str(path), device="cpu").graph.adj,
                       want.adj)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_begin_and_partial_do_not_wait_for_the_walk_on_card(cuda):
    """``begin`` queues its work behind a busy stream without a host sync
    (sync debug mode "error"), and a deadline partial completes before its
    flight's continue, which a sleep kernel holds back: bit-identical to a
    partial and a search of the same lanes."""
    q = _world("cuda")[1][:8]
    eng = _engine("tiered", device="cuda")
    want = eng.search(q)
    want_part = eng.partial_result(eng.begin(q))
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(SLEEP_CYCLES)               # the stream is busy
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        f = eng.begin(q)
        t_begin = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not f.probe_event.query()                  # queued, not run
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(SLEEP_CYCLES)               # holds the continue
    done = []
    t = threading.Thread(
        target=lambda: done.append((eng.finish_from(f), time.perf_counter())))
    t.start()
    part = eng.partial_result(f)
    t_part = time.perf_counter()
    t.join(timeout=120)
    assert not t.is_alive()
    full, t_full = done[0]
    assert t_begin < 0.04 and t_part < t_full
    np.testing.assert_array_equal(part.ids, want_part.ids)
    np.testing.assert_array_equal(part.d2, want_part.d2)
    np.testing.assert_array_equal(full.ids, want.ids)
    np.testing.assert_array_equal(full.d2, want.d2)


@pytest.mark.gpu
def test_partial_of_a_cold_engine_does_not_wait_for_the_walk_on_card(cuda):
    """An engine that has served nothing: its first ``begin`` queued behind
    a busy stream, then a sleep kernel four times as long (about 200 ms)
    holding the continue; its first partial (the partial stream's first
    allocations) must come back more than 100 ms before the held
    continue's result, bit-identical to a warm engine's partial and search
    of the same lanes."""
    q = _world("cuda")[1][:8]
    warm = _engine("tiered", device="cuda")
    want = warm.search(q)
    want_part = warm.partial_result(warm.begin(q))
    torch.cuda.synchronize()
    eng = _engine("tiered", device="cuda")
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(SLEEP_CYCLES)               # the stream is busy
    f = eng.begin(q)
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(4 * SLEEP_CYCLES)           # holds the continue
    done = []
    t = threading.Thread(
        target=lambda: done.append((eng.finish_from(f), time.perf_counter())))
    t.start()
    part = eng.partial_result(f)
    t_part = time.perf_counter()
    t.join(timeout=120)
    assert not t.is_alive()
    full, t_full = done[0]
    print(f"cold engine: partial {1e3 * (t_full - t_part):.1f} ms before "
          f"the held continue's result")
    assert t_full - t_part > 0.1
    np.testing.assert_array_equal(part.ids, want_part.ids)
    np.testing.assert_array_equal(part.d2, want_part.d2)
    np.testing.assert_array_equal(full.ids, want.ids)
    np.testing.assert_array_equal(full.d2, want.d2)
