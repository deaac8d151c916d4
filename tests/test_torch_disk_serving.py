"""The port's disk slow tier and its serving path against the reference.

* ``BlockSlowTier``: its counters (hits, misses, blocks_read, io_blocks,
  cached_nodes) equal the reference tier's on one replayed fetch sequence,
  in node order and packed; the LRU bound, the pins, prefetch futures,
  ``close``, concurrent fetches and the ``default_io_workers`` rules.
* ``HotTier``: residency (``slot``, ``node_of``) and the frequency EMA equal
  the reference's after the same accesses and drained ticks; decay
  overtake, tie hysteresis, and promotion that never blocks a fetch.
* The engine: ``TieredBackend`` over the port's ``BlockSlowTier`` is
  bit-identical to the port's in-memory backend (adaptive with
  ``num_buckets`` None / 3 / "auto", one batch at a time and pipelined, and
  fixed), with and without a hot tier; on integer-valued data it is
  bit-identical to the reference's disk-tier engine.
* The launcher's ``--index`` / ``--disk`` path on the CPU.
* ``gpu``-marked: the pipelined disk engine on the card (side stream,
  prefetch stage) bit-identical to the in-memory engine there, and the hot
  tier's device mirror.  The reference is imported inside a fixture, so the
  file also runs on a machine without JAX (``pytest -m gpu --noconftest``).
"""
import concurrent.futures as cf
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.index import blockstore as tbs  # noqa: E402
from repro_torch.index import convert  # noqa: E402
from repro_torch.index import disk as tdisk  # noqa: E402

torch.set_num_threads(1)
N, D, R = 64, 12, 6
NW, NQ, K, BEAM = 800, 24, 10, 24
BUDGET_KW = dict(l_min=6, l_max=BEAM, lam=0.3, center=7.0)
TIMING = ("read_time_s", "measured_read_us", "promotion_read_time_s")


@pytest.fixture(scope="module")
def jx():
    """The reference's modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import serving
    from repro.core import build, search
    from repro.core.types import GraphIndex
    from repro.data import make_dataset
    from repro.index import blockstore, build_tiered_index, disk
    from repro.pq import PqCodebook, pq_encode
    return types.SimpleNamespace(
        jnp=jnp, serving=serving, build=build, search=search,
        GraphIndex=GraphIndex, make_dataset=make_dataset, bs=blockstore,
        build_tiered_index=build_tiered_index, disk=disk,
        PqCodebook=PqCodebook, pq_encode=pq_encode)


def _arrays(tiered) -> dict:
    g = tiered.graph
    return {k: np.asarray(v) for k, v in dict(
        adj=g.adj, entry=g.entry, alpha=g.alpha, lid=g.lid, mu=g.mu,
        sigma=g.sigma, centroids=tiered.codebook.centroids,
        codes=tiered.codes, vectors=tiered.vectors).items()}


@pytest.fixture(scope="module")
def world(jx, tmp_path_factory):
    """An index the reference built on tiny-uniform (D = 32, R = 12), its
    integer twin (vectors, queries and codebook scaled by 16 and rounded,
    codes re-encoded by the reference) and block stores of both."""
    x, q = jx.make_dataset("tiny-uniform", seed=0)
    x, q = x[:NW], q[:NQ]
    cfg = jx.build.BuildConfig(degree=12, beam_width=24, iters=1, batch=200,
                               max_hops=48)
    graph = jx.build.build_mcgi(x, cfg)
    tiered = jx.build_tiered_index(x, graph, m_pq=8)
    xi = np.round(np.asarray(x) * 16).astype(np.float32)
    qi = np.round(np.asarray(q) * 16).astype(np.float32)
    book_i = jx.PqCodebook(jx.jnp.round(tiered.codebook.centroids * 16))
    tiered_i = jx.disk.TieredIndex(
        graph=graph, codebook=book_i,
        codes=jx.pq_encode(jx.jnp.asarray(xi), book_i),
        vectors=jx.jnp.asarray(xi))
    d = tmp_path_factory.mktemp("stores")
    adj = np.asarray(graph.adj)
    return dict(
        q=np.array(q), qi=qi, tiered=tiered, tiered_i=tiered_i,
        port=convert.tiered_index_from_arrays(_arrays(tiered), "cpu"),
        port_i=convert.tiered_index_from_arrays(_arrays(tiered_i), "cpu"),
        store=tbs.write_block_store(d / "f.blocks", np.asarray(x), adj),
        packed=tbs.write_block_store(
            d / "p.blocks", np.asarray(x), adj, nodes_per_block=4,
            slot_of=jx.build.block_layout(graph, 4)),
        store_i=tbs.write_block_store(d / "i.blocks", xi, adj))


@pytest.fixture()
def store_path(tmp_path):
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(N, D)).astype(np.float32)
    adj = rng.integers(-1, N, size=(N, R)).astype(np.int32)
    return tbs.write_block_store(tmp_path / "t.blocks", vectors, adj), \
        vectors, adj


def _tier(p, **kw):
    return tdisk.BlockSlowTier(tbs.BlockStore(p), **kw)


def _counters(st: dict) -> dict:
    return {k: v for k, v in st.items() if k not in TIMING}


# ------------------------------------------------------------ the tier


@pytest.mark.parametrize("packed", [False, True])
def test_tier_counters_equal_reference_on_replayed_stream(jx, tmp_path,
                                                          packed):
    rng = np.random.default_rng(1)
    vectors = rng.normal(size=(200, D)).astype(np.float32)
    adj = rng.integers(-1, 200, size=(200, R)).astype(np.int32)
    slot_of = rng.permutation(200) if packed else None
    p = tbs.write_block_store(tmp_path / "s.blocks", vectors, adj,
                              nodes_per_block=4 if packed else 1,
                              slot_of=slot_of)
    pins = tdisk.entry_proximal_ids(adj, 3, limit=12)
    kw = dict(cache_nodes=40, pinned_ids=pins)
    ours = _tier(p, **kw)
    ref = jx.disk.BlockSlowTier(jx.bs.BlockStore(p), **kw)
    try:
        assert _counters(ours.stats()) == _counters(ref.stats())
        for step in range(24):
            what = step % 4
            if what == 0:
                ids = rng.integers(-1, 200, size=(5, 7))
                np.testing.assert_array_equal(ours.fetch_beams(ids),
                                              ref.fetch_beams(ids))
            elif what == 1:
                ids = rng.integers(-1, 200, size=(9,))
                np.testing.assert_array_equal(ours.fetch_adj(ids),
                                              ref.fetch_adj(ids))
            elif what == 2:
                ids = rng.integers(0, 40, size=(15,))       # a hot range
                for got, want in zip(ours.fetch_records(ids),
                                     ref.fetch_records(ids)):
                    np.testing.assert_array_equal(got, want)
            elif step == 11:
                ours.reset_stats()
                ref.reset_stats()
            elif step == 19:
                ours.clear_cache()
                ref.clear_cache()
            assert _counters(ours.stats()) == _counters(ref.stats()), step
        assert ours.stats()["cache_hits"] > 0
    finally:
        ours.close()
        ref.close()


def test_lru_eviction_bounds_cache_and_keeps_pins(store_path):
    p, vectors, _ = store_path
    tier = _tier(p, cache_nodes=4, pinned_ids=np.asarray([60]))
    tier.fetch(np.arange(10))
    st = tier.stats()
    assert st["cached_nodes"] == 4 and st["pinned_nodes"] == 1
    assert st["cache_misses"] == 10 and st["blocks_read"] == 10
    tier.reset_stats()
    np.testing.assert_array_equal(tier.fetch(np.asarray([60]))[0],
                                  vectors[60])
    assert tier.stats()["cache_hits"] == 1
    assert tier.stats()["blocks_read"] == 0


def test_prefetch_future_matches_direct_fetch(store_path):
    p, vectors, adj = store_path
    with _tier(p, cache_nodes=N) as tier:
        beams = np.asarray([[1, 4, -1], [44, 2, 9]])
        want = np.zeros((*beams.shape, D), np.float32)
        want[beams >= 0] = vectors[beams[beams >= 0]]
        np.testing.assert_array_equal(tier.prefetch(beams).result(), want)
        np.testing.assert_array_equal(tier.fetch_beams(beams), want)
        u = np.asarray([3, -1, 44])
        rows = tier.prefetch_adj(u).result()
        np.testing.assert_array_equal(rows[[0, 2]], adj[[3, 44]])
        assert (rows[1] == -1).all()


def test_close_shuts_down_worker_and_is_idempotent(store_path):
    def n_workers():
        return sum("slow-tier-prefetch" in t.name
                   for t in threading.enumerate())

    p, vectors, _ = store_path
    base = n_workers()
    with _tier(p, cache_nodes=8) as tier:
        tier.prefetch(np.asarray([[1, 2]])).result()
        assert n_workers() == base + 1
    assert tier.closed and n_workers() == base
    fut = tier.prefetch(np.asarray([[1, 2]]))      # synchronous after close
    assert fut.done() and n_workers() == base
    np.testing.assert_array_equal(fut.result()[0, 0], vectors[1])
    np.testing.assert_array_equal(tier.fetch(np.asarray([5]))[0], vectors[5])
    tier.close()


def test_concurrent_fetches_bit_exact_with_exact_counter_totals(store_path):
    p, vectors, adj = store_path
    rng = np.random.default_rng(11)
    beams = [rng.integers(-1, N, size=(4, 5)) for _ in range(10)]
    frontiers = [rng.integers(-1, N, size=(7,)) for _ in range(10)]
    beams_total = sum(np.unique(b[b >= 0]).size for b in beams)
    expected = sum(np.unique(a[a >= 0]).size
                   for a in beams + frontiers) + beams_total

    def check(tier, b, u):
        out = tier.fetch_beams(b)
        np.testing.assert_array_equal(out[b >= 0], vectors[b[b >= 0]])
        rows = tier.prefetch_adj(u).result()
        np.testing.assert_array_equal(rows[u >= 0], adj[u[u >= 0]])
        assert (rows[u < 0] == -1).all()
        out = tier.prefetch(b).result()
        np.testing.assert_array_equal(out[b >= 0], vectors[b[b >= 0]])

    def race(tier):
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            for f in [pool.submit(check, tier, b, u)
                      for b, u in zip(beams, frontiers)]:
                f.result(timeout=60)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)             # interleave the threads finely
    try:
        with _tier(p, cache_nodes=N, io_workers=4) as tier:
            race(tier)
            st = tier.stats()
            assert st["cache_hits"] + st["cache_misses"] == expected
            tier.reset_stats()
            race(tier)
            st = tier.stats()
            assert st["cache_misses"] == 0 and st["blocks_read"] == 0
            assert st["cache_hits"] == expected
    finally:
        sys.setswitchinterval(switch)


def test_default_io_workers_adoption_rules(store_path):
    p, _, _ = store_path
    with _tier(p, io_workers=3) as t:
        t.default_io_workers(8)
        assert t.io_workers == 3
    with _tier(p) as t:
        t.default_io_workers(4)
        assert t.io_workers == 4
        t.default_io_workers(9)
        assert t.io_workers == 4
    with _tier(p) as t:
        t.prefetch(np.asarray([[1]])).result()
        t.default_io_workers(6)
        assert t.io_workers is None


def test_fetch_latency_window(store_path):
    p, _, _ = store_path
    with _tier(p) as tier:
        assert tier.fetch_latency_us()["fetch_samples"] == 0
        assert tier.fetch_latency_us()["fetch_p99_us"] == 0.0
        for _ in range(5):
            tier.fetch_records(np.asarray([1, 2, 3]))
        lat = tier.fetch_latency_us()
        assert lat["fetch_samples"] == 5
        assert 0.0 < lat["fetch_p50_us"] <= lat["fetch_p99_us"]
        tier.reset_stats()
        assert tier.fetch_latency_us()["fetch_samples"] == 0


# -------------------------------------------------------- the hot tier


@pytest.mark.parametrize("capacity,chunk,decay", [(8, 8, 0.5), (16, 4, 0.8),
                                                  (4, 2, 1.0)])
def test_hot_tier_residency_equals_reference(jx, store_path, capacity, chunk,
                                             decay):
    p, vectors, adj = store_path
    kw = dict(cache_nodes=4, pinned_ids=np.asarray([0, 1]),
              hot_nodes=capacity, hot_chunk=chunk, freq_decay=decay)
    ours = _tier(p, **kw)
    ref = jx.disk.BlockSlowTier(jx.bs.BlockStore(p), **kw)
    rng = np.random.default_rng(capacity)
    try:
        for rnd in range(8):
            hot = (rnd // 3) * 10                    # the hot set drifts
            for _ in range(3):
                ids = np.concatenate([rng.integers(hot, hot + 12, 6),
                                      rng.integers(0, N, 4)])
                got, want = ours.fetch_records(ids), ref.fetch_records(ids)
                np.testing.assert_array_equal(got[0], vectors[ids])
                np.testing.assert_array_equal(got[1], want[1])
            ours.promotion_tick().result()
            ref.promotion_tick().result()
            for a in ("slot", "node_of", "freq", "vectors", "adj"):
                np.testing.assert_array_equal(getattr(ours._hot, a),
                                              getattr(ref._hot, a),
                                              err_msg=f"{a} round {rnd}")
            assert _counters(ours.stats()) == _counters(ref.stats()), rnd
        assert ours.stats()["promotions"] > 0
        assert ours.stats()["hot_hits"] > 0
    finally:
        ours.close()
        ref.close()


def test_decay_lets_shifted_hot_set_overtake(store_path):
    p, _, _ = store_path
    tier = _tier(p, cache_nodes=0, hot_nodes=2, hot_chunk=2, freq_decay=0.5)
    try:
        for _ in range(4):
            tier.fetch_records(np.asarray([1, 2]))
        tier.promotion_tick().result()
        assert set(tier._hot.node_of.tolist()) == {1, 2}
        for _ in range(4):
            tier.fetch_records(np.asarray([3, 4]))
        tier.promotion_tick().result()
        st = tier.stats()
        assert st["demotions"] == 2 and st["hot_nodes"] == 2
        assert set(tier._hot.node_of.tolist()) == {3, 4}
    finally:
        tier.close()


def test_hysteresis_never_demotes_on_ties(store_path):
    p, _, _ = store_path
    tier = _tier(p, cache_nodes=0, hot_nodes=1, hot_chunk=1, freq_decay=1.0)
    try:
        tier.fetch_records(np.asarray([5]))
        tier.promotion_tick().result()
        tier.fetch_records(np.asarray([6]))
        tier.promotion_tick().result()
        assert tier.stats()["demotions"] == 0
        assert tier._hot.node_of.tolist() == [5]
    finally:
        tier.close()


def test_promotion_never_blocks_serving(store_path):
    """With the promoter's block read held on an event: the in-flight tick
    is returned again, stats and a serving fetch return, and the promotion
    read never shows in the serving counters."""
    p, vectors, adj = store_path
    tier = _tier(p, cache_nodes=8, hot_nodes=4, hot_chunk=4)
    gate, entered = threading.Event(), threading.Event()
    try:
        tier.fetch_records(np.asarray([1, 2, 3]))
        real = tier._hot.store.read_many

        def gated(ids):
            entered.set()
            assert gate.wait(30.0)
            return real(ids)

        tier._hot.store.read_many = gated
        fut = tier.promotion_tick()
        assert entered.wait(30.0)
        assert tier.promotion_tick() is fut
        before = tier.stats()
        ids = np.asarray([7, 8])
        v, a = tier.fetch_records(ids)
        np.testing.assert_array_equal(v, vectors[ids])
        np.testing.assert_array_equal(a, adj[ids])
        st = tier.stats()
        assert st["blocks_read"] == before["blocks_read"] + 2
        assert st["promotion_io_blocks"] == before["promotion_io_blocks"]
        gate.set()
        fut.result()
        assert tier.stats()["promotions"] == 3
        assert tier.promotion_tick() is not fut
        tier.drain_promotions()
    finally:
        gate.set()
        tier.close()


def test_promotion_tick_lifecycle(store_path):
    p, _, _ = store_path
    with _tier(p) as plain:
        assert plain.promotion_tick() is None
    tier = _tier(p, hot_nodes=4)
    tier.fetch_records(np.asarray([1, 2]))
    tier.promotion_tick()
    promoters = set(tier._hot._pool._threads)
    tier.close()
    assert tier.promotion_tick() is None
    assert promoters and not any(t.is_alive() for t in promoters)
    tier.fetch_records(np.asarray([1, 2]))


# ---------------------------------------------------------- the engine


def _budget():
    return tsearch.AdaptiveBeamBudget(**BUDGET_KW)


def _disk_tier(path, **kw):
    kw.setdefault("cache_nodes", 128)
    return _tier(path, **kw)


def _same(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.d2, want.d2)


@pytest.mark.parametrize("num_buckets", [None, 3, "auto"])
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("store", ["store", "packed"])
def test_disk_engine_equals_in_memory(world, num_buckets, pipelined, store):
    q, port = world["q"], world["port"]
    mem = tserving.SearchEngine(tserving.TieredBackend(port, device="cpu"),
                                _budget(), k=K, num_buckets=num_buckets)
    tier = _disk_tier(world[store],
                      pinned_ids=tdisk.entry_proximal_ids(
                          port.graph.adj, port.graph.entry, limit=16))
    disk = tserving.SearchEngine(
        tserving.TieredBackend(port, slow_tier=tier, device="cpu"),
        _budget(), k=K, num_buckets=num_buckets)
    batches = [q[:8], q[8:16], q[16:]]
    if pipelined:
        got = list(disk.search_batches(batches))
        want = list(mem.search_batches(batches))
    else:
        got = [disk.search(b) for b in batches]
        want = [mem.search(b) for b in batches]
    for g, w in zip(got, want):
        _same(g, w)
        np.testing.assert_array_equal(g.stats.hops, w.stats.hops)
        assert g.ceilings == w.ceilings
        assert g.extras["slow_tier"]["cache_misses"] > 0
        assert "slow_tier" not in w.extras
    disk.close()
    assert tier.closed


def test_disk_engine_fixed_and_seams_equal_in_memory(world):
    """Fixed beam (walk un-reranked, then the block rerank), the
    begin/finish_from seam, the partial result and coalesced micro-batches
    over the disk tier equal the in-memory engine."""
    q, port = world["q"], world["port"]
    tier = _disk_tier(world["store"])
    back = tserving.TieredBackend(port, slow_tier=tier, device="cpu")
    mem_back = tserving.TieredBackend(port, device="cpu")
    fixed = tserving.SearchEngine(back, None, k=K, beam_width=BEAM)
    fixed_mem = tserving.SearchEngine(mem_back, None, k=K, beam_width=BEAM)
    _same(fixed.search(q), fixed_mem.search(q))
    assert "slow_tier" in fixed.search(q).extras
    eng = tserving.SearchEngine(back, _budget(), k=K)
    mem = tserving.SearchEngine(mem_back, _budget(), k=K)
    f = eng.begin(q)
    _same(eng.partial_result(f), mem.partial_result(mem.begin(q)))
    _same(eng.finish_from(f), mem.search(q))
    co = tserving.SearchEngine(back, _budget(), k=K, coalesce_lanes=16)
    merged = list(co.search_batches([q[:8], q[8:16], q[16:]]))
    assert [r.ids.shape[0] for r in merged] == [8, 8, 8]
    np.testing.assert_array_equal(np.concatenate([r.ids for r in merged]),
                                  mem.search(q).ids)
    tier.close()


@pytest.mark.parametrize("mode", ["adaptive", "pipelined", "fixed"])
def test_disk_engine_bit_identical_to_reference_integer(jx, world, mode):
    """On integer-valued data the port's disk engine equals the reference's
    disk engine (its TieredBackend over its BlockSlowTier) bit for bit, and
    the tiers count the same traffic (a pipelined batch's counters are a
    snapshot taken while the next batch's fetch may run, so the stream is
    compared on its totals)."""
    qi = world["qi"]
    jtier = jx.disk.BlockSlowTier(jx.bs.BlockStore(world["store_i"]),
                                  cache_nodes=128)
    ttier = _disk_tier(world["store_i"])
    fixed = mode == "fixed"
    jcfg = None if fixed else jx.search.AdaptiveBeamBudget(**BUDGET_KW)
    common = dict(k=K, beam_width=BEAM, max_hops=64)
    jeng = jx.serving.SearchEngine(
        jx.serving.TieredBackend(world["tiered_i"], slow_tier=jtier), jcfg,
        **common)
    teng = tserving.SearchEngine(
        tserving.TieredBackend(world["port_i"], slow_tier=ttier,
                               device="cpu"),
        None if fixed else _budget(), **common)
    batches = [qi[:8], qi[8:16], qi[16:]]
    if mode == "pipelined":
        got = list(teng.search_batches(batches))
        want = list(jeng.search_batches(batches))
    else:
        got = [teng.search(b) for b in batches]
        want = [jeng.search(b) for b in batches]
    for g, w in zip(got, want):
        _same(g, w)
        np.testing.assert_array_equal(g.stats.hops, w.stats.hops)
        if not fixed:
            np.testing.assert_array_equal(g.astats.budget, w.astats.budget)
        if mode != "pipelined":   # a stream's snapshot races the next fetch
            assert (_counters(g.extras["slow_tier"])
                    == _counters(w.extras["slow_tier"]))
    assert _counters(ttier.stats()) == _counters(jtier.stats())
    teng.close()
    jeng.close()


def test_hot_tier_engine_bit_identical_while_residency_moves(world):
    q, port = world["q"], world["port"]
    tier = _disk_tier(world["store"], cache_nodes=32, hot_nodes=128,
                      hot_chunk=32, freq_decay=0.5)
    disk = tserving.SearchEngine(
        tserving.TieredBackend(port, slow_tier=tier, device="cpu"),
        _budget(), k=K)
    mem = tserving.SearchEngine(tserving.TieredBackend(port, device="cpu"),
                                _budget(), k=K)
    batches = [q[:8], q[8:16], q[16:]]
    want = list(mem.search_batches(batches))
    for _ in range(3):
        for g, w in zip(disk.search_batches(batches), want):
            _same(g, w)
        tier.drain_promotions()
    st = tier.stats()
    assert st["promotion_ticks"] >= 3 and st["promotions"] > 0
    assert st["hot_hits"] > 0
    promoters = set(tier._hot._pool._threads)
    disk.close()
    assert tier.closed
    assert promoters and not any(t.is_alive() for t in promoters)


def test_refresh_names_the_slow_tier_and_closes_the_old_one(world):
    port = world["port"]
    old = _disk_tier(world["store"])
    back = tserving.TieredBackend(port, slow_tier=old, device="cpu")
    eng = tserving.SearchEngine(back, _budget(), k=K)
    assert back.prefetches
    with pytest.raises(ValueError, match="slow_tier"):
        eng.update_backend(port)
    assert not old.closed
    new = _disk_tier(world["store"])
    eng.update_backend(port, slow_tier=new)
    assert old.closed and not new.closed and back.slow_tier is new
    eng.update_backend(port, slow_tier=None)
    assert new.closed and not back.prefetches
    eng.update_backend(port)                    # in memory: no tier to name
    eng.close()
    eng.close()                                 # idempotent
    norerank = tserving.TieredBackend(port, rerank=False,
                                      slow_tier=_disk_tier(world["store"]),
                                      device="cpu")
    assert not norerank.prefetches
    norerank.close()


def test_launcher_serves_from_disk(tmp_path, capsys):
    """``--index`` builds and saves, then loads; ``--disk`` writes the store,
    then reuses it; both runs print the disk-tier line."""
    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--n", "1500", "--degree", "16",
            "--l-build", "32", "--batch", "16", "--num-batches", "3",
            "--index", str(tmp_path / "i.npz"),
            "--disk", str(tmp_path / "d.blocks")]
    serve.main(argv + ["--adaptive", "--pipeline", "--hot-nodes", "128",
                       "--hot-chunk", "64", "--io-workers", "2"])
    out = capsys.readouterr().out
    assert "[serve] wrote block store" in out
    assert "[serve] disk tier: hit_rate=" in out
    assert "[serve] hot tier: resident=" in out
    assert (tmp_path / "i.npz").exists()
    mtime = (tmp_path / "d.blocks").stat().st_mtime_ns
    serve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] loaded index: n=1500" in out
    assert "wrote block store" not in out
    assert "[serve] disk tier: hit_rate=" in out
    assert (tmp_path / "d.blocks").stat().st_mtime_ns == mtime
    rec = float(out.split("recall@10=")[1].split()[0])
    assert rec > 0.8


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_world(card, tmp_path):
    from repro_torch.data import make_dataset
    from repro_torch.index import build_tiered_index

    x, q = make_dataset("tiny-uniform", device="cpu", n=1500)
    g = tbuild.build_mcgi(x, tbuild.BuildConfig(degree=12, beam_width=24,
                                                batch=256, max_hops=48),
                          device="cpu")
    cpu = build_tiered_index(x, g, m_pq=8, device="cpu")
    arrays = {k: v.numpy() if isinstance(v, torch.Tensor) else v
              for k, v in dict(adj=g.adj, entry=g.entry, alpha=g.alpha,
                               lid=g.lid, mu=g.mu, sigma=g.sigma,
                               centroids=cpu.codebook.centroids,
                               codes=cpu.codes, vectors=cpu.vectors).items()}
    index = convert.tiered_index_from_arrays(arrays, card)
    tier = tdisk.open_or_build_slow_tier(tmp_path / "c.blocks", index,
                                         cache_nodes=256, pin_nodes=32)
    return index, tier, q.numpy()


@pytest.mark.gpu
def test_disk_engine_on_card_bit_identical(card, tmp_path):
    """Pipelined (side stream, prefetch stage) and per batch: the disk
    engine on the card equals the in-memory engine there, bit for bit, and
    every batch walked through the beam_step kernel."""
    from repro_torch.kernels import ops

    index, tier, q = _card_world(card, tmp_path)
    mem = tserving.SearchEngine(tserving.TieredBackend(index, device=card),
                                _budget(), k=K)
    disk = tserving.SearchEngine(
        tserving.TieredBackend(index, slow_tier=tier, device=card),
        _budget(), k=K)
    batches = [q[i:i + 20] for i in range(0, 100, 20)]
    ops.reset_launch_counts()
    got = list(disk.search_batches(batches))
    assert ops.launch_counts()["beam_step.pq"] >= len(batches)
    for g, w in zip(got, list(mem.search_batches(batches))):
        _same(g, w)
    for b, w in zip(batches, got):
        _same(disk.search(b), w)
    fixed = tserving.SearchEngine(disk.backend, None, k=K, beam_width=BEAM)
    fixed_mem = tserving.SearchEngine(mem.backend, None, k=K,
                                      beam_width=BEAM)
    _same(fixed.search(q[:64]), fixed_mem.search(q[:64]))
    disk.close()


@pytest.mark.gpu
def test_hot_tier_device_mirror_on_card(card, tmp_path):
    """The hot tier's device mirror holds its host arrays, on the card."""
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(N, D)).astype(np.float32)
    adj = rng.integers(-1, N, size=(N, R)).astype(np.int32)
    p = tbs.write_block_store(tmp_path / "m.blocks", vectors, adj)
    tier = _tier(p, cache_nodes=0, hot_nodes=8, hot_chunk=8,
                 hot_device_mirror=True, mirror_device=card)
    try:
        for ids in ([1, 2, 3], [3, 9, 12, 40], [40, 41]):
            tier.fetch_records(np.asarray(ids))
            tier.promotion_tick().result()
            hot = tier._hot
            for dev_t, host in ((hot.device_vectors, hot.vectors),
                                (hot.device_adj, hot.adj),
                                (hot.device_node_of, hot.node_of)):
                assert dev_t.device.type == "cuda"
                np.testing.assert_array_equal(dev_t.cpu().numpy(), host)
        resident = hot.node_of[hot.node_of >= 0]
        np.testing.assert_array_equal(
            hot.device_vectors.cpu().numpy()[hot.slot[resident]],
            vectors[resident])
    finally:
        tier.close()
