"""The port's out-of-core walk and its serving backend against the
reference and against the port's in-memory walk.

* ``ooc_init_pq`` / ``ooc_select_pq`` / ``ooc_hop_pq`` against the
  reference's, hop by hop on integer-valued codes and LUTs: states,
  frontiers and activity bit-identical, a filtered (``excl``) and scrubbed
  state included; the plain row-fed hop against ``beam_step_ref``.
* ``ooc_walk``, ``ooc_probe``, ``ooc_continue`` and ``ooc_first_frontier``
  against the reference's and against the in-memory ``run_batch`` walk,
  with ``io_groups`` 1, 2 and 3.
* ``OutOfCoreBackend`` through ``SearchEngine``: bit-identical to the
  port's in-memory ``TieredBackend`` (buckets None / 3 / "auto", eager,
  pipelined with a ragged tail, coalesced, a packed store, fixed beam, the
  walk-prefetch stage, a hot tier), typed refresh errors, zero-query
  batches; on integer data bit-identical to the reference's backend, with
  equal tier counters on a per-batch stream at ``io_groups=1``.
* ``gpu``-marked: the row-fed hop on the card against its plain version,
  and the pipelined out-of-core engine on the card bit-identical to the
  in-memory one.  The reference is imported inside a fixture, so the file
  also runs on a machine without JAX (``pytest -m gpu --noconftest``).
"""
import concurrent.futures as cf
import sys
import threading
import time
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
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)
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
    from repro.data import make_dataset
    from repro.index import blockstore, build_tiered_index, disk
    from repro.pq import PqCodebook, pq_encode
    return types.SimpleNamespace(
        jnp=jnp, serving=serving, build=build, search=search,
        make_dataset=make_dataset, bs=blockstore,
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
    codes re-encoded by the reference), and block stores: node order, packed
    8 a block, and the integer twin's."""
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
    d = tmp_path_factory.mktemp("ooc_stores")
    adj = np.asarray(graph.adj)
    return dict(
        q=np.array(q), qi=qi, tiered_i=tiered_i,
        port=convert.tiered_index_from_arrays(_arrays(tiered), "cpu"),
        port_i=convert.tiered_index_from_arrays(_arrays(tiered_i), "cpu"),
        store=tbs.write_block_store(d / "f.blocks", np.asarray(x), adj),
        packed=tbs.write_block_store(
            d / "p.blocks", np.asarray(x), adj, nodes_per_block=8,
            slot_of=jx.build.block_layout(graph, 8)),
        store_i=tbs.write_block_store(d / "i.blocks", xi, adj))


def _budget():
    return tsearch.AdaptiveBeamBudget(**BUDGET_KW)


def _tier(path, **kw):
    kw.setdefault("cache_nodes", 128)
    return tdisk.BlockSlowTier(tbs.BlockStore(path), **kw)


def _ooc(index, tier, **kw):
    return tserving.OutOfCoreBackend(index.codes, index.codebook,
                                     index.graph.entry, tier, device="cpu",
                                     **kw)


def _counters(st: dict) -> dict:
    return {k: v for k, v in st.items() if k not in TIMING}


def _np(t):
    a = np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
    return a.view(np.uint32) if a.dtype == np.int32 and a.ndim == 2 else a


def _same_tree(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _np(a), _np(b)
        if a.dtype == np.int32 and b.dtype == np.uint32:
            a = a.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: leaf {i}")


def _same(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.d2, want.d2)
    np.testing.assert_array_equal(np.asarray(got.stats.hops),
                                  np.asarray(want.stats.hops))
    if want.astats is not None:
        np.testing.assert_array_equal(np.asarray(got.astats.budget),
                                      np.asarray(want.astats.budget))
    assert got.ceilings == want.ceilings


def _fetch(adj, u):
    """``adj[u]``, all-INVALID rows where u is INVALID (the tier's
    ``fetch_adj``)."""
    u = np.asarray(u)
    return np.where((u >= 0)[:, None], adj[np.maximum(u, 0)], -1).astype(
        np.int32)


def _luts_i(world):
    """Integer-valued LUTs of the integer twin's queries (the port's admit;
    every entry a sum of squared integers)."""
    back = tserving.TieredBackend(world["port_i"], device="cpu")
    luts = back.admit(world["qi"])
    assert torch.equal(luts, luts.round())
    return luts


# ---------------------------------------------------------- the programs


@pytest.mark.parametrize("filtered", [False, True])
def test_select_and_hops_equal_reference(jx, world, filtered):
    """Hop by hop on integer data: init, select and hops to convergence
    at the probe's budget, (a scrub of the filtered state), then a second
    segment under per-lane budgets — states, frontiers and activity equal
    the reference's after every call."""
    port = world["port_i"]
    codes, adj = port.codes, port.graph.adj.numpy()
    n = codes.shape[0]
    luts = _luts_i(world)
    jn = jx.jnp
    codes_j, luts_j = jn.asarray(codes.numpy()), jn.asarray(luts.numpy())
    entry = int(port.graph.entry)
    excl = excl_j = None
    if filtered:
        rng = np.random.default_rng(3)
        allowed = rng.random((NQ, n)) < 0.7
        allowed[:, entry] = False               # the entry is filtered out
        excl = tsearch.pack_filter(allowed, n, device="cpu")
        excl_j = jx.search.pack_filter(jn.asarray(allowed), n)
    st = tsearch.ooc_init_pq(codes, luts, entry, n, BEAM, excl=excl)
    st_j = jx.search.ooc_init_pq(codes_j, luts_j, jn.asarray(entry), n,
                                 BEAM, excl=excl_j)
    _same_tree(st, st_j, "init")
    rng = np.random.default_rng(5)
    segments = [(np.full(NQ, 6, np.int32), np.full(NQ, 6, np.int32)),
                (rng.integers(6, BEAM + 1, NQ).astype(np.int32),
                 rng.integers(8, 40, NQ).astype(np.int32))]
    for seg, (bud, hl) in enumerate(segments):
        if seg == 1 and filtered:
            st = tsearch._scrub_state(st, excl)
            st_j = jx.search._scrub_state(st_j, excl_j)
        st, u, act = tsearch.ooc_select_pq(st, torch.from_numpy(bud),
                                           torch.from_numpy(hl), BEAM)
        st_j, u_j, act_j = jx.search.ooc_select_pq(
            st_j, jn.asarray(bud), jn.asarray(hl), BEAM)
        _same_tree((*st, u, act), (*st_j, u_j, act_j), f"select {seg}")
        for h in range(40):
            if not bool(act.any()):
                break
            rows = _fetch(adj, u.numpy())
            st, u, act = tsearch.ooc_hop_pq(
                codes, st, u, act, rows, luts, torch.from_numpy(bud),
                torch.from_numpy(hl), BEAM)
            st_j, u_j, act_j = jx.search.ooc_hop_pq(
                codes_j, st_j, u_j, act_j, jn.asarray(rows), luts_j,
                jn.asarray(bud), jn.asarray(hl), BEAM)
            _same_tree((*st, u, act), (*st_j, u_j, act_j),
                       f"segment {seg} hop {h}")
        assert not bool(act.any())


def test_row_fed_hops_walk_as_beam_step_ref():
    """The plain row-fed hop, select then hops with ``adj[u]``, ends where
    ``beam_walk_ref`` ends (the marks of the last select are where the
    walk's next hop would put them), on random float data; a hop with
    every lane inactive is the select, and other kinds are refused."""
    g = torch.Generator().manual_seed(0)
    n, q, width, r, m, k = 300, 12, 16, 8, 4, 16
    adj = tbuild.random_graph(n, r, g)
    codes = torch.randint(0, k, (n, m), generator=g, dtype=torch.uint8)
    luts = torch.rand((q, m, k), generator=g)
    entry = torch.randint(0, n, (), generator=g, dtype=torch.int32)
    st0 = tsearch.ooc_init_pq(codes, luts, entry, n, width)
    bud = torch.randint(4, width + 1, (q,), generator=g, dtype=torch.int32)
    hl = torch.randint(1, 30, (q,), generator=g, dtype=torch.int32)
    want, _ = ref.beam_walk_ref(st0, luts, adj, codes, bud, hl, kind="pq",
                                max_hops=10_000)
    st, u, act = ops.beam_hop_rows(st0, None, None, None, None, None, bud,
                                   hl, kind="pq")
    same = ops.beam_hop_rows(st0, u, torch.zeros_like(act),
                             torch.from_numpy(_fetch(adj.numpy(), u)), luts,
                             codes, bud, hl, kind="pq")
    _same_tree((*same[0], same[1], same[2]), (*st, u, act), "inactive hop")
    while bool(act.any()):
        st, u, act = ops.beam_hop_rows(
            st, u, act, torch.from_numpy(_fetch(adj.numpy(), u)), luts,
            codes, bud, hl, kind="pq")
    _same_tree(st, want, "walk")
    with pytest.raises(ValueError, match="pq"):
        ops.beam_hop_rows(st0, None, None, None, None, None, bud, hl,
                          kind="exact")


@pytest.mark.parametrize("io_groups", [1, 2, 3])
def test_ooc_drivers_equal_reference_and_memory(jx, world, io_groups):
    """``ooc_probe`` / ``ooc_first_frontier`` / ``ooc_continue`` on integer
    data equal the reference's drivers and the port's in-memory probe and
    continue; ``ooc_walk`` at a fixed beam equals ``run_batch``."""
    port, jn = world["port_i"], jx.jnp
    codes, n = port.codes, port.codes.shape[0]
    luts = _luts_i(world)
    cfg = _budget()
    jcfg = jx.search.AdaptiveBeamBudget(**BUDGET_KW)
    tier = _tier(world["store_i"])
    jtier = jx.disk.BlockSlowTier(jx.bs.BlockStore(world["store_i"]),
                                  cache_nodes=128)
    try:
        got = tdisk.ooc_probe(codes, luts, port.graph.entry, n, cfg, tier,
                              io_groups=io_groups)
        want = jx.disk.ooc_probe(jn.asarray(codes.numpy()),
                                 jn.asarray(luts.numpy()),
                                 jn.asarray(int(port.graph.entry)), n, jcfg,
                                 jtier, io_groups=io_groups)
        mem = tsearch.adaptive_probe_batch(luts, port.graph.adj,
                                           port.graph.entry,
                                           tsearch._pq_eval(codes), n, cfg)
        _same_tree((*got[0], *got[1:3]), (*want[0], *want[1:3]), "probe")
        _same_tree((*got[0], *got[1:3]), (*mem[0], *mem[1:3]), "probe mem")
        np.testing.assert_array_equal(got[3].numpy(), mem[3].numpy())
        probe, bud, hl = got[0], got[1], got[2]
        u = tdisk.ooc_first_frontier(probe, bud, hl, BEAM)
        np.testing.assert_array_equal(u, np.asarray(
            jx.disk.ooc_first_frontier(want[0], want[1], want[2], BEAM)))
        _same_tree(probe, want[0], "first frontier left the state")
        cont = tdisk.ooc_continue(codes, probe, luts, bud, hl, BEAM, tier,
                                  io_groups=io_groups)
        jcont = jx.disk.ooc_continue(jn.asarray(codes.numpy()), want[0],
                                     jn.asarray(luts.numpy()), want[1],
                                     want[2], BEAM, jtier,
                                     io_groups=io_groups)
        mcont = tsearch.adaptive_continue_batch(
            probe, luts, port.graph.adj, tsearch._pq_eval(codes), cfg, bud,
            hl)
        _same_tree(cont, jcont, "continue")
        _same_tree(cont, mcont, "continue mem")
        st = tsearch.ooc_init_pq(codes, luts, port.graph.entry, n, BEAM)
        walked = tdisk.ooc_walk(codes, st, luts, BEAM, 64, BEAM, tier,
                                io_groups)
        _same_tree(walked, tsearch.run_batch(st, luts, port.graph.adj,
                                             tsearch._pq_eval(codes), BEAM,
                                             64), "fixed walk")
    finally:
        tier.close()
        jtier.close()


def test_ooc_walk_timings_and_empty_batch(world):
    """``timings`` counts host hops, walks and the phases of a hop; a
    zero-lane walk returns its input."""
    port = world["port"]
    luts = tserving.TieredBackend(port, device="cpu").admit(world["q"])
    n = port.codes.shape[0]
    tier = _tier(world["store"])
    try:
        st = tsearch.ooc_init_pq(port.codes, luts, port.graph.entry, n, BEAM)
        t: dict = {}
        out = tdisk.ooc_walk(port.codes, st, luts, BEAM, 64, BEAM, tier, 2,
                             timings=t)
        assert t["walks"] == 1 and t["hops"] >= int(out[4].max())
        assert all(t[k] >= 0.0 for k in ("wait_s", "copy_s", "launch_s",
                                         "sync_s", "walk_s"))
        empty = tuple(a[:0] for a in st)
        assert tdisk.ooc_walk(port.codes, empty, luts[:0], BEAM, 64, BEAM,
                              tier) is empty
    finally:
        tier.close()


def test_ooc_walk_timings_add_up_across_threads(world, monkeypatch):
    """Two threads walk into one ``timings`` dict at once under a 1 us
    switch interval; its sums equal those of the same walks run one after
    the other.  A clock of each thread's own, one tick a read, makes every
    walk's times exact, and the shared dict yields its thread between the
    read and the write of an update, so a lost update shows."""
    port = world["port"]
    luts = tserving.TieredBackend(port, device="cpu").admit(world["q"])
    n = port.codes.shape[0]
    st = tsearch.ooc_init_pq(port.codes, luts, port.graph.entry, n, BEAM)
    own = threading.local()

    def tick():
        own.t = getattr(own, "t", 0) + 1
        return float(own.t)

    monkeypatch.setattr(tdisk, "time", types.SimpleNamespace(
        perf_counter=tick))
    tier = _tier(world["store"])

    def walks(timings, reps=4):
        for _ in range(reps):
            tdisk.ooc_walk(port.codes, st, luts, BEAM, 64, BEAM, tier, 2,
                           timings=timings)

    try:
        alone: dict = {}
        walks(alone)
        walks(alone)
        class Yielding(dict):
            def get(self, key, default=None):
                out = super().get(key, default)
                time.sleep(1e-4)          # let the other thread run
                return out

        shared = Yielding()
        errors: list = []

        def run():
            try:
                walks(shared)
            except Exception as e:      # reported below
                errors.append(repr(e))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=run) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert shared == alone and shared["walks"] == 8
    finally:
        tier.close()


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("num_buckets", [None, 3, "auto"])
def test_ooc_engine_equals_tiered(world, num_buckets):
    """Eager, pipelined with a ragged tail, and coalesced: the out-of-core
    engine equals the in-memory tiered engine bit for bit (ids, d2, hops,
    granted budgets, bucket families)."""
    q, port = world["q"], world["port"]
    tier = _tier(world["store"])
    mem = tserving.SearchEngine(tserving.TieredBackend(port, device="cpu"),
                                _budget(), k=K, num_buckets=num_buckets)
    eng = tserving.SearchEngine(_ooc(port, tier), _budget(), k=K,
                                num_buckets=num_buckets)
    _same(eng.search(q), mem.search(q))
    batches = [q[i:i + 9] for i in range(0, NQ, 9)]      # ragged tail
    got = list(eng.search_batches(batches))
    assert len(got) == len(batches)
    for g, w in zip(got, mem.search_batches(batches)):
        _same(g, w)
        assert g.extras["slow_tier"]["cache_misses"] > 0
    co = [tserving.SearchEngine(b, _budget(), k=K, num_buckets=num_buckets,
                                coalesce_lanes=10)
          for b in (eng.backend, mem.backend)]
    small = [q[i:i + 5] for i in range(0, NQ, 5)]
    for g, w in zip(*(c.search_batches(small) for c in co)):
        _same(g, w)
    eng.close()
    assert tier.closed


def test_ooc_engine_packed_store_fixed_and_seams(world):
    """A packed store (8 records a block), fixed beam, and the
    begin / partial / finish_from seam equal the in-memory engine."""
    q, port = world["q"], world["port"]
    tier = _tier(world["packed"])
    assert tier.store.nodes_per_block == 8
    back, mem_back = _ooc(port, tier), tserving.TieredBackend(port,
                                                              device="cpu")
    eng = tserving.SearchEngine(back, _budget(), k=K)
    mem = tserving.SearchEngine(mem_back, _budget(), k=K)
    _same(eng.search(q), mem.search(q))
    f = eng.begin(q)
    _same(eng.partial_result(f), mem.partial_result(mem.begin(q)))
    _same(eng.finish_from(f), mem.search(q))
    assert isinstance(f.walk_prefetch, cf.Future)
    for bw, hops in ((BEAM, 96), (16, 8)):
        fixed = tserving.SearchEngine(back, None, k=K, beam_width=bw,
                                      max_hops=hops)
        fixed_mem = tserving.SearchEngine(mem_back, None, k=K,
                                          beam_width=bw, max_hops=hops)
        got = fixed.search(q)
        _same(got, fixed_mem.search(q))
        assert "slow_tier" in got.extras
    tier.close()


def test_ooc_walk_prefetch_stage(world):
    """The out-of-core engine runs the walk-prefetch stage first in its
    pipeline, the disk-tier engine does not; io_depth=1 (one node read
    ahead) gives the same bits as the default 32."""
    q, port = world["q"], world["port"]
    tier = _tier(world["store"])
    eng = tserving.SearchEngine(_ooc(port, tier), _budget(), k=K)
    assert eng._walk_prefetching()
    disk = tserving.SearchEngine(
        tserving.TieredBackend(port, slow_tier=_tier(world["store"]),
                               device="cpu"), _budget(), k=K)
    assert not disk._walk_prefetching()
    disk.close()
    one = tserving.SearchEngine(_ooc(port, _tier(world["store"]),
                                     io_depth=1), _budget(), k=K)
    batches = [q[:8], q[8:16], q[16:]]
    for g, w in zip(one.search_batches(batches),
                    eng.search_batches(batches)):
        _same(g, w)
    fut = one.backend.prefetch_walk(*one.backend.probe(
        one.backend.admit(q), _budget())[:3])
    assert fut.result().shape == (1, port.graph.adj.shape[1])
    one.close()
    eng.close()


def test_ooc_refresh_zero_query_and_device_state(world):
    """A refresh must name the slow tier (TypeError) and a disk one
    (ValueError), a replaced tier is closed; zero-query batches serve empty
    results; the backend holds no (N, R) or (N, D) tensor."""
    q, port = world["q"], world["port"]
    t1, t2 = _tier(world["store"]), _tier(world["store"])
    back = _ooc(port, t1)
    with pytest.raises(TypeError):
        back.update(port.codes, port.codebook, port.graph.entry)
    with pytest.raises(ValueError, match="BlockSlowTier"):
        back.update(port.codes, port.codebook, port.graph.entry,
                    slow_tier=None)
    with pytest.raises(ValueError, match="BlockSlowTier"):
        back.update(port.codes, port.codebook, port.graph.entry,
                    slow_tier=tdisk.InMemorySlowTier(port.vectors))
    assert not t1.closed
    back.update(port.codes, port.codebook, port.graph.entry, slow_tier=t2)
    assert t1.closed and not t2.closed and back.slow_tier is t2
    n, r = port.graph.adj.shape
    held = [v for v in vars(back).values() if isinstance(v, torch.Tensor)]
    held.append(back.codebook.centroids)
    assert held and all(t.numel() not in (n * r, n * port.vectors.shape[1])
                        for t in held)
    eng = tserving.SearchEngine(back, _budget(), k=K)
    r0 = eng.search(q[:0])
    assert r0.ids.shape == (0, K) and r0.d2.shape == (0, K)
    r0 = tserving.SearchEngine(back, None, k=K, beam_width=BEAM).search(q[:0])
    assert r0.ids.shape == (0, K)
    eng.close()
    assert t2.closed
    eng.close()                                     # idempotent


def test_ooc_hot_tier_adopts_ticks_and_closes(world):
    """Through the engine: the backend sizes the tier's prefetch pool to
    its io_groups, every gather kicks a promotion tick, the walk's reads
    hit the hot tier, results stay bit-identical while residency moves,
    and close tears the promoter down."""
    q, port = world["q"], world["port"]
    tier = _tier(world["store"], cache_nodes=32, hot_nodes=128,
                 hot_chunk=32)
    assert tier.io_workers is None
    back = _ooc(port, tier, io_groups=3)
    assert tier.io_workers == 3
    eng = tserving.SearchEngine(back, _budget(), k=K)
    mem = tserving.SearchEngine(tserving.TieredBackend(port, device="cpu"),
                                _budget(), k=K)
    want = mem.search(q)
    _same(eng.search(q), want)
    tier.drain_promotions()
    res = eng.search(q)
    _same(res, want)
    st = res.extras["slow_tier"]
    assert st["promotion_ticks"] >= 1 and st["promotions"] > 0
    assert st["hot_hits"] > 0
    promoters = set(tier._hot._pool._threads)
    eng.close()
    assert tier.closed
    assert promoters and not any(t.is_alive() for t in promoters)


@pytest.mark.parametrize("mode", ["per_batch", "pipelined", "fixed",
                                  "filtered"])
def test_ooc_engine_bit_identical_to_reference_integer(jx, world, mode):
    """On integer data the port's out-of-core engine equals the reference's
    bit for bit; served per batch with io_groups=1 (one worker, so the
    reads run in one order) the tiers count the same traffic after every
    batch (hits, misses, blocks read, I/O blocks)."""
    qi, port = world["qi"], world["port_i"]
    tiered_i = world["tiered_i"]
    groups = 2 if mode == "pipelined" else 1
    jtier = jx.disk.BlockSlowTier(jx.bs.BlockStore(world["store_i"]),
                                  cache_nodes=128)
    ttier = _tier(world["store_i"])
    fixed = mode == "fixed"
    common = dict(k=K, beam_width=BEAM, max_hops=64)
    jeng = jx.serving.SearchEngine(
        jx.serving.OutOfCoreBackend(tiered_i.codes, tiered_i.codebook,
                                    tiered_i.graph.entry, jtier,
                                    io_groups=groups),
        None if fixed else jx.search.AdaptiveBeamBudget(**BUDGET_KW),
        **common)
    teng = tserving.SearchEngine(_ooc(port, ttier, io_groups=groups),
                                 None if fixed else _budget(), **common)
    batches = [qi[:8], qi[8:16], qi[16:]]
    flt = None
    if mode == "filtered":
        rng = np.random.default_rng(7)
        flt = rng.random(port.codes.shape[0]) < 0.6
    if mode == "pipelined":
        pairs = zip(teng.search_batches(batches),
                    jeng.search_batches(batches))
    else:
        pairs = ((teng.search(b, filter=flt), jeng.search(b, filter=flt))
                 for b in batches)
    for g, w in pairs:
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.d2, w.d2)
        np.testing.assert_array_equal(np.asarray(g.stats.hops),
                                      np.asarray(w.stats.hops))
        if not fixed:
            np.testing.assert_array_equal(g.astats.budget,
                                          np.asarray(w.astats.budget))
        if groups == 1:
            assert (_counters(g.extras["slow_tier"])
                    == _counters(w.extras["slow_tier"]))
        if flt is not None:
            assert not np.isin(g.ids[g.ids >= 0],
                               np.flatnonzero(~flt)).any()
    if groups == 1:
        assert _counters(ttier.stats()) == _counters(jtier.stats())
    teng.close()
    jeng.close()


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hop_problem(dev, integer: bool, seed: int, n=5000, q=96, width=64,
                 r=32, m=16, k=256):
    g = torch.Generator(device=dev).manual_seed(seed)
    adj = tbuild.random_graph(n, r, g)
    codes = torch.randint(0, k, (n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    luts = (torch.randint(0, 64, (q, m, k), generator=g, device=dev).float()
            if integer else
            torch.rand((q, m, k), generator=g, device=dev) * 64.0)
    entries = torch.randint(0, n, (q,), generator=g, device=dev,
                            dtype=torch.int32)
    excl = tsearch.pack_filter(
        torch.rand((q, n), generator=g, device=dev).cpu().numpy() < 0.8, n,
        device=dev)
    st = tsearch._init_state(luts, entries[:1].reshape(()),
                             tsearch._pq_eval(codes), n, width, excl)
    bud = torch.randint(width // 2, width + 1, (q,), generator=g,
                        device=dev, dtype=torch.int32)
    hl = torch.randint(2, 40, (q,), generator=g, device=dev,
                       dtype=torch.int32)
    return st, luts, adj, codes, bud, hl, excl


def _rows(adj, u):
    return torch.where((u >= 0)[:, None], adj[u.clamp_min(0).long()],
                       torch.full_like(adj[:1], -1))


@pytest.mark.gpu
@pytest.mark.parametrize("integer", [True, False])
def test_hop_rows_on_card_equals_plain(card, integer):
    """The row-fed hop on the card against ``beam_hop_rows_ref``: the
    select (both forms), filtered walks to convergence, a scrubbed state
    and shuffled (unsorted) beams.  Each launch starts from the plain version's state.  Integer
    LUTs: bit for bit.  Float LUTs (the kernel adds the M terms in m order,
    the plain version in its own): beam_d within 1e-5, and ids, visited,
    frontier and activity equal in every lane without a near-tie."""
    from repro_torch.kernels import beam_step as beam_mod

    st, luts, adj, codes, bud, hl, excl = _hop_problem(card, integer, 1)

    def tie(d):
        s = torch.sort(d, 1).values
        gap = s[:, 1:] - s[:, :-1]
        return ((gap <= 1e-5 * s[:, 1:].abs()) & torch.isfinite(s[:, 1:])
                ).any(1)

    def check(got, want, before, what):
        leaves = list(zip((*got[0], got[1], got[2]),
                          (*want[0], want[1], want[2])))
        if integer:
            for i, (a, b) in enumerate(leaves):
                assert torch.equal(a, b), f"{what}: leaf {i}"
            return
        ok = tie(before) | tie(want[0][1])
        for i, (a, b) in enumerate(leaves):
            if i != 1:
                same = (a == b).reshape(a.shape[0], -1).all(1)
                assert bool((same | ok).all()), f"{what}: leaf {i}"
        fin = torch.isfinite(want[0][1])
        assert torch.equal(torch.isfinite(got[0][1]) | ok[:, None],
                           fin | ok[:, None]), what
        keep = fin & ~ok[:, None]
        torch.testing.assert_close(got[0][1][keep], want[0][1][keep],
                                   rtol=1e-5, atol=0)

    def hop(state, u, act, hl):
        rows = None if act is None else _rows(adj, u)
        args = (None, None) if act is None else (luts, codes)
        return (ref.beam_hop_rows_ref(state, u, act, rows, *args, bud, hl,
                                      kind="pq"),
                beam_mod.beam_hop_rows_cuda(
                    tuple(t.clone() for t in state), u, act, rows, *args,
                    bud, hl, kind="pq"))

    want, got = hop(st, None, None, hl)
    check(got, want, st[1], "select")
    _, got = hop(st, want[1], torch.zeros_like(want[2]), hl)
    check(got, want, st[1], "inactive hop")
    for seg in range(2):
        for h in range(60):
            if not bool(want[2].any()):
                break
            before = want[0][1]
            want, got = hop(want[0], want[1], want[2], hl)
            check(got, want, before, f"segment {seg} hop {h}")
        # Scrub, shuffle the beams, and walk on under wider limits.
        sc = tsearch._scrub_state(want[0], excl)
        perm = torch.argsort(torch.rand(sc[0].shape, device=card), 1)
        sc = tuple(torch.gather(t, 1, perm) if i < 3 else t
                   for i, t in enumerate(sc))
        hl = hl + 20
        want, got = hop(sc, None, None, hl)
        check(got, want, sc[1], f"select after scrub {seg}")


@pytest.mark.gpu
def test_ooc_engine_on_card_bit_identical(card, tmp_path):
    """Pipelined (side stream, walk-prefetch and prefetch stages) and per
    batch, and fixed beam: the out-of-core engine on the card equals the
    in-memory tiered engine there bit for bit, every hop through the
    row-fed kernel and none through the resident walk."""
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
    q = q.numpy()
    mem = tserving.SearchEngine(tserving.TieredBackend(index, device=card),
                                _budget(), k=K)
    back = tserving.OutOfCoreBackend(index.codes, index.codebook,
                                     index.graph.entry, tier, device=card)
    back.timings = {}
    eng = tserving.SearchEngine(back, _budget(), k=K)
    batches = [q[i:i + 20] for i in range(0, 100, 20)]
    want = list(mem.search_batches(batches))
    ops.reset_launch_counts()
    got = list(eng.search_batches(batches))
    counts = ops.launch_counts()
    assert counts["beam_step.pq_rows"] > 0 and counts["beam_step.pq"] == 0
    assert back.timings["hops"] > 0 and back.timings["walks"] > 0
    for gr, w in zip(got, want):
        _same(gr, w)
    for b, w in zip(batches, want):
        _same(eng.search(b), w)
    fixed = tserving.SearchEngine(back, None, k=K, beam_width=BEAM)
    fixed_mem = tserving.SearchEngine(mem.backend, None, k=K,
                                      beam_width=BEAM)
    _same(fixed.search(q[:64]), fixed_mem.search(q[:64]))
    eng.close()
