"""The port's write path (``repro_torch.index.delta``) against the reference.

* The properties of the reference's ``tests/test_delta.py`` on the port
  (the online build's ragged-batch determinism is
  ``tests/test_torch_online.py::test_port_builds_ragged_deterministic``):
  the ``valid=`` mask of the reverse insert, insert determinism, bounded staleness, base and delta
  tombstones, merge-boundary bit identity against a fresh build, a flight
  begun before ``merge`` finishing bit-identical, stable external ids,
  auto-merge with the lineage, and ``merge_async`` under traffic.
* ``DeltaTier`` over the reference's base graph (carried across with
  ``graph_index_from_arrays``): inserts, deletes, ``delta_topk`` and
  ``search_exact`` bit-identical to the reference's ``DeltaTier`` on
  integer data (alpha_min == alpha_max, so alpha does not depend on LID;
  LID within rtol 1e-4).
* Both ``LiveIndex`` objects started from the same base (the reference's
  graph and an integer-valued PQ tier, carried across with
  ``repro_torch.index.convert``): the same inserts, deletes, searches and
  merge give equal external ids and bit-identical d2.
* The lineage read across packages both ways, and the engine's packing of
  a shared filter mask.
"""
import functools
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import distance as tdist  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.index import convert  # noqa: E402
from repro_torch.index import serializer as tserializer  # noqa: E402
from repro_torch.index.delta import DeltaTier, LiveIndex  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
KW = dict(degree=16, beam_width=32, iters=1, batch=128, max_hops=64)
CFG = tbuild.BuildConfig(**KW)
# Integer parity: alpha constant, so no LID ulp can move a prune decision.
KW_EQ = dict(KW, alpha_min=1.2, alpha_max=1.2)
D = 12


@functools.lru_cache(maxsize=1)
def _corpus():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((390, D)).astype(np.float32)   # 390 % 128 != 0
    q = rng.standard_normal((12, D)).astype(np.float32)
    return x, q


@functools.lru_cache(maxsize=1)
def _int_corpus():
    """Integer vectors in a wide range: every sum exact, distance ties rare
    (the reference's delta scan sorts unstably)."""
    rng = np.random.default_rng(10)
    x = rng.integers(-20, 21, (390, D)).astype(np.float32)
    q = rng.integers(-20, 21, (12, D)).astype(np.float32)
    vecs = rng.integers(-20, 21, (150, D)).astype(np.float32)
    return x, q, vecs


def _live(x, **kw):
    kw.setdefault("merge_threshold", 10_000)               # manual merges
    return LiveIndex(x, CFG, k=5, beam_width=32, max_hops=64, m_pq=4,
                     device="cpu", **kw)


@pytest.fixture(scope="module")
def J():
    """The reference, imported here so that the file loads without JAX (the
    card's machine runs its ``gpu`` test)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import build, online
    from repro.index import build_tiered_index, delta, disk, save_index
    from repro.index import serializer
    from repro.pq import PqCodebook, pq_encode

    return types.SimpleNamespace(
        jnp=jnp, build=build, online=online, delta=delta, disk=disk,
        serializer=serializer, build_tiered_index=build_tiered_index,
        save_index=save_index, PqCodebook=PqCodebook, pq_encode=pq_encode)


# --------------------------------------------------------------- determinism


def test_insert_reverse_valid_mask_drops_pad_lanes():
    """A pad lane repeating a live destination with an all-INVALID pool
    loses to the real lane: the masked call equals the single-lane call."""
    rng = np.random.default_rng(1)
    x = T(rng.standard_normal((40, D)).astype(np.float32))
    adj = tbuild.random_graph(40, CFG.degree, torch.Generator().manual_seed(0))
    alpha = torch.full((40,), 1.1)
    dest1 = torch.tensor([3], dtype=torch.int32)
    cand1 = torch.arange(10, 10 + CFG.reverse_cap, dtype=torch.int32)[None]
    ref = tbuild._insert_reverse(x, adj.clone(), alpha, dest1, cand1, CFG)
    pad = torch.full((1, CFG.reverse_cap), -1, dtype=torch.int32)
    got = tbuild._insert_reverse(x, adj.clone(), alpha,
                                 torch.cat([dest1, dest1]),
                                 torch.cat([cand1, pad]), CFG,
                                 valid=torch.tensor([True, False]))
    assert torch.equal(ref, got)


def test_delta_insert_deterministic():
    x, _q = _corpus()
    graph = tonline.build_online_mcgi(x, CFG, device="cpu")
    vecs = np.random.default_rng(2).standard_normal((150, D)).astype(
        np.float32)                                          # 150 % 128 != 0
    served = {name: getattr(graph, name).clone()
              for name in ("adj", "alpha", "lid")}
    tiers = []
    for _ in range(2):
        t = DeltaTier(x, graph, CFG)
        assert np.array_equal(t.insert(vecs), np.arange(390, 540))
        tiers.append(t)
    for name in ("x", "adj", "alpha", "lid"):
        assert torch.equal(getattr(tiers[0], name), getattr(tiers[1], name))
    # Copy-on-extend: the base tensors the engine serves are untouched.
    for name, before in served.items():
        assert torch.equal(getattr(graph, name), before), name
    assert tiers[0].adj.shape[0] == 540


# ---------------------------------------------------------- staleness bounds


def test_bounded_staleness_insert_findable_immediately():
    x, q = _corpus()
    li = _live(x)
    try:
        for r in range(3):
            rng = np.random.default_rng(100 + r)
            near = q[:6] + 0.01 * rng.standard_normal((6, D)).astype(
                np.float32)
            ids = li.insert(near, auto_merge=False)
            ext, _d2 = li.search(q[:6])
            for i in range(6):
                assert ids[i] in ext[i], (r, i)
            own, d2 = li.search(near)              # each finds itself first
            assert np.array_equal(own[:, 0], ids) and (d2[:, 0] == 0).all()
    finally:
        li.close()


def test_delete_tombstones_base_and_delta():
    x, q = _corpus()
    li = _live(x)
    try:
        ids = li.insert(q[:4] + 1e-3, auto_merge=False)
        ext, _ = li.search(q[:4])
        assert np.isin(ids, ext).any()
        li.delete(ids)                            # delta tombstones
        ext2, _ = li.search(q[:4])
        assert not np.isin(ext2, ids).any()
        base_hit = int(ext2[0, 0])                # base tombstone, in-graph
        li.delete([base_hit])
        ext3, _ = li.search(q[:4])
        assert not (ext3 == base_hit).any()
        with pytest.raises(KeyError):
            li.delete([10 ** 9])
        loc, _ = li._state.delta.search_exact(q[:4], beam_width=32, k=5)[:2]
        assert not np.isin(loc.numpy(), np.append(ids, base_hit)).any()
    finally:
        li.close()


# ----------------------------------------------------------- merge lifecycle


def test_merge_boundary_bit_identity():
    """Post-merge searches are bit-identical to a fresh LiveIndex built over
    the same live rows."""
    x, q = _corpus()
    li = _live(x)
    li2 = None
    try:
        rng = np.random.default_rng(3)
        ids = li.insert(rng.standard_normal((40, D)).astype(np.float32),
                        auto_merge=False)
        li.delete(ids[:10])
        li.delete(np.arange(5))                   # base deletes too
        assert li.merge() == 1
        ext, d2 = li.search(q)
        st = li._state
        assert st.delta.n == 390 + 40 - 15 and li.delta_size == 0
        li2 = _live(st.delta.x.numpy())           # fresh build, same rows
        extf, d2f = li2.search(q)
        mapped = np.where(extf >= 0, st.ext_of[np.maximum(extf, 0)], -1)
        np.testing.assert_array_equal(mapped, ext)
        np.testing.assert_array_equal(d2f, d2)
    finally:
        li.close()
        if li2 is not None:
            li2.close()


def test_search_during_merge_snapshot(tmp_path):
    """A flight begun before the merge finishes bit-identical to its
    pre-merge result, across the backend swap and the old store's tier
    being closed."""
    x, q = _corpus()
    li = _live(x, store_dir=tmp_path, nodes_per_block=4)
    try:
        rng = np.random.default_rng(4)
        ids = li.insert(rng.standard_normal((30, D)).astype(np.float32),
                        auto_merge=False)
        li.delete(ids[:5])
        li.delete([7])                            # a base tombstone: filtered
        flt = li._state.delta.live_base_mask()
        assert flt is not None and not flt[7]
        pre = li.engine.search(q, filter=flt)
        flight = li.engine.begin(q, filter=flt)
        li.merge()
        got = li.engine.finish_from(flight)
        np.testing.assert_array_equal(got.ids, pre.ids)
        np.testing.assert_array_equal(got.d2, pre.d2)
        names = sorted(p.name for p in tmp_path.iterdir())
        assert "live.g1.blocks" in names and not any(
            n.endswith(".tmp") for n in names)
        assert set(li.build_timings) >= {"bootstrap", "rewire_walks", "prune",
                                         "reverse_insert", "pq_tier",
                                         "layout", "store"}
        ext, _ = li.search(q)
        assert (ext >= 0).all()
    finally:
        li.close()


def test_ext_ids_stable_across_merges():
    x, _q = _corpus()
    li = _live(x)
    try:
        rng = np.random.default_rng(5)
        probe = rng.standard_normal((1, D)).astype(np.float32)
        pid = int(li.insert(probe, auto_merge=False)[0])
        for cycle in range(2):
            li.insert(rng.standard_normal((20, D)).astype(np.float32),
                      auto_merge=False)
            li.delete(li.insert(rng.standard_normal((3, D)).astype(
                np.float32), auto_merge=False))
            li.merge()
            ext, _ = li.search(probe, 1)
            assert int(ext[0, 0]) == pid, cycle
        assert li.generation == 2
    finally:
        li.close()


def test_auto_merge_threshold_and_lineage(J, tmp_path):
    x, _q = _corpus()
    li = _live(x, merge_threshold=32)
    try:
        rng = np.random.default_rng(6)
        li.insert(rng.standard_normal((40, D)).astype(np.float32))
        assert li.generation == 1
        assert li.delta_size == 0 and li.n_live == 430
        p = tmp_path / "live.npz"
        li.save(p)
        lin = tserializer.load_lineage(p)
        assert lin["generation"] == 1 and lin["inserts"] == 40
        assert lin["merges"] == 1 and lin["live"] == 430
        # The reference reads the port's lineage.
        assert J.serializer.load_lineage(p) == lin
    finally:
        li.close()


def test_lineage_written_by_reference_reads_in_port(J, tmp_path):
    tiered = _ref_base(J, _int_corpus()[0].tobytes())
    lineage = {"generation": 3, "merges": 3, "inserts": 17, "deletes": 4,
               "live": 390, "mu": 9.5}
    p, plain = tmp_path / "ref.npz", tmp_path / "plain.npz"
    J.save_index(p, tiered, lineage=lineage)
    J.save_index(plain, tiered)
    assert tserializer.load_lineage(p) == lineage
    assert tserializer.load_lineage(plain) is None


def test_merge_async_under_traffic():
    x, q = _corpus()
    li = _live(x)
    try:
        rng = np.random.default_rng(7)
        li.insert(rng.standard_normal((25, D)).astype(np.float32),
                  auto_merge=False)
        li.delete([0, 1])
        t = li.merge_async()
        for _ in range(4):
            ext, _ = li.search(q)
            assert (ext >= 0).all() and not np.isin(ext, [0, 1]).any()
        t.join(timeout=300)
        assert not t.is_alive() and li.generation == 1 and t.generation == 1
        ext, _ = li.search(q)
        assert (ext >= 0).all() and not np.isin(ext, [0, 1]).any()
    finally:
        li.close()


def test_merge_drift_recalibrates_before_publish():
    """A merge whose mean LID moves past ``drift_threshold`` refits the
    budget law on the new index: the published law is the engine's own
    ``recalibrate`` against brute-force ground truth over the merged rows,
    live together with the new generation."""
    from repro_torch.index.delta import _brute_force_gt

    x, q = _corpus()
    budget = tsearch.AdaptiveBeamBudget(l_min=8, l_max=32, lam=0.3)
    li = _live(x, budget_cfg=budget, calib=q, drift_threshold=0.0,
               recall_target=0.9)
    try:
        li.delete([0, 1, 2])
        assert li.merge() == 1 and li.lineage["recalibrations"] == 1
        gt = _brute_force_gt(li._state.delta.x, q, 5)
        fit = tserving.SearchEngine(
            tserving.TieredBackend(li.engine.backend.index, device="cpu"),
            budget, k=5)
        fit.recalibrate(q, gt, recall_target=0.9)
        assert li.engine.budget_cfg == fit.budget_cfg
        assert li.engine.budget_cfg != budget
        ext, _ = li.search(q)
        assert (ext >= 0).all() and not np.isin(ext, [0, 1, 2]).any()
    finally:
        li.close()


def test_merge_async_reraises_at_join():
    x, _q = _corpus()
    li = _live(x)
    try:
        def boom(*_a, **_k):
            raise RuntimeError("build failed")

        li._build_base = boom
        t = li.merge_async()
        with pytest.raises(RuntimeError, match="build failed"):
            t.join(timeout=60)
        assert not t.is_alive() and li.generation == 0
    finally:
        li.close()


def test_writes_and_searches_race_a_merge():
    """Searcher threads, a writer and a background merge, with a short
    switch interval: no search fails or returns a deleted id, and no write
    is lost to the merge (every inserted vector finds itself after it)."""
    x, q = _corpus()
    li = _live(x)
    errors: list = []
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        li.delete([3, 4])
        rng = np.random.default_rng(8)
        vecs = rng.standard_normal((12, D)).astype(np.float32)

        def searcher():
            try:
                while not stop.is_set():
                    ext, _ = li.search(q)
                    if np.isin(ext, [3, 4]).any() or (ext < 0).all():
                        errors.append("deleted or empty result")
            except Exception as e:   # reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=searcher) for _ in range(6)]
        for t in threads:
            t.start()
        m = li.merge_async()
        ext_ids = [li.insert(v, auto_merge=False)[0] for v in vecs]
        m.join(timeout=120)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not m.is_alive() and not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        own, d2 = li.search(vecs, 1)
        np.testing.assert_array_equal(own[:, 0], ext_ids)
        assert (d2[:, 0] == 0).all() and li.n_live == 390 - 2 + 12
    finally:
        stop.set()
        sys.setswitchinterval(old)
        li.close()


# --------------------------------------------- parity with the reference


_REF_BASES: dict = {}


def _ref_base(J, rows: bytes):
    """The reference's online build over integer rows, with an integer PQ
    tier (its trained centroids rounded, codes re-encoded), so every
    float32 sum in the walks and reranks is exact.  Cached by the rows."""
    if rows not in _REF_BASES:
        jnp = J.jnp
        x = jnp.asarray(np.frombuffer(rows, np.float32).reshape(-1, D))
        graph = J.online.build_online_mcgi(x, J.build.BuildConfig(**KW_EQ))
        tiered = J.build_tiered_index(x, graph, m_pq=4)
        book = J.PqCodebook(jnp.round(tiered.codebook.centroids))
        _REF_BASES[rows] = J.disk.TieredIndex(
            graph=graph, codebook=book, codes=J.pq_encode(x, book),
            vectors=x)
    return _REF_BASES[rows]


def _arrays(tiered) -> dict:
    g = tiered.graph
    return {k: np.asarray(v) for k, v in dict(
        adj=g.adj, entry=g.entry, alpha=g.alpha, lid=g.lid, mu=g.mu,
        sigma=g.sigma, centroids=tiered.codebook.centroids,
        codes=tiered.codes, vectors=tiered.vectors).items()}


def _same_up_to_ties(ids, d2, want_ids, want_d2):
    """d2 bit-identical; ids equal within each group of equal distances
    (the reference's scan sorts unstably; the port's ties go to the lower
    id, which it must have taken), except a group cut at column k."""
    np.testing.assert_array_equal(d2, want_d2)
    for i, wi, d in zip(ids, want_ids, d2):
        assert (i[np.isinf(d)] == -1).all() and (wi[np.isinf(d)] == -1).all()
        for v in np.unique(d[np.isfinite(d)]):
            sel = d == v
            assert np.all(np.diff(i[sel]) > 0)
            if not sel[-1]:
                assert set(i[sel]) == set(wi[sel])


def test_delta_tier_bit_identical_to_reference_integer(J):
    x, q, vecs = _int_corpus()
    ref = _ref_base(J, x.tobytes())
    jt = J.delta.DeltaTier(J.jnp.asarray(x), ref.graph,
                           J.build.BuildConfig(**KW_EQ))
    tt = DeltaTier(x, convert.graph_index_from_arrays(_arrays(ref), "cpu"),
                   tbuild.BuildConfig(**KW_EQ))
    np.testing.assert_array_equal(tt.insert(vecs), jt.insert(vecs))
    np.testing.assert_array_equal(tt.adj.numpy(), np.asarray(jt.adj))
    np.testing.assert_array_equal(tt.alpha.numpy(), np.asarray(jt.alpha))
    np.testing.assert_allclose(tt.lid.numpy(), np.asarray(jt.lid), rtol=1e-4)
    for t in (jt, tt):
        t.delete([5, 17, 391, 500])
    np.testing.assert_array_equal(tt.live_mask, jt.live_mask)
    np.testing.assert_array_equal(tt.live_base_mask(), jt.live_base_mask())
    for k in (5, 40, 160):
        jid, jd2 = jt.delta_topk(q, k)
        tid, td2 = tt.delta_topk(q, k)
        _same_up_to_ties(tid.numpy(), td2.numpy(), jid, jd2)
    jid, jd2, js = jt.search_exact(q, beam_width=32, k=10)
    tid, td2, ts = tt.search_exact(q, beam_width=32, k=10)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(ts.hops.numpy(), np.asarray(js.hops))


def test_delta_topk_pads_when_few_rows_live(J):
    x, q, vecs = _int_corpus()
    ref = _ref_base(J, x.tobytes())
    tt = DeltaTier(x, convert.graph_index_from_arrays(_arrays(ref), "cpu"),
                   tbuild.BuildConfig(**KW_EQ))
    ids, d2 = tt.delta_topk(q, 4)
    assert (ids.numpy() == -1).all() and torch.isinf(d2).all()
    tt.insert(vecs[:3])
    tt.delete([391])
    ids, d2 = tt.delta_topk(q, 4)
    assert set(np.unique(ids.numpy()[:, :2])) <= {390, 392}
    assert (ids.numpy()[:, 2:] == -1).all() and torch.isinf(d2[:, 2:]).all()


def test_live_index_end_to_end_matches_reference(J, monkeypatch):
    """Both LiveIndex objects over the same base at every generation: the
    same inserts, deletes, searches and merge give the same external ids
    and bit-identical d2."""
    x, q, vecs = _int_corpus()

    def port_base(self, x_new, generation):
        ref = _ref_base(J, x_new.cpu().numpy().astype(np.float32).tobytes())
        tiered = convert.tiered_index_from_arrays(_arrays(ref), "cpu")
        return tiered.graph, tiered, None

    def ref_base(self, x_new, generation):
        ref = _ref_base(J, np.asarray(x_new, np.float32).tobytes())
        return ref.graph, ref, None

    monkeypatch.setattr(LiveIndex, "_build_base", port_base)
    monkeypatch.setattr(J.delta.LiveIndex, "_build_base", ref_base)
    kw = dict(k=5, beam_width=32, max_hops=64, m_pq=4,
              merge_threshold=10_000)
    tl = LiveIndex(x, tbuild.BuildConfig(**KW_EQ), device="cpu", **kw)
    jl = J.delta.LiveIndex(x, J.build.BuildConfig(**KW_EQ), **kw)

    def same():
        te, td = tl.search(q)
        je, jd = jl.search(q)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(td, jd)

    try:
        same()                                     # merge boundary
        for li in (tl, jl):
            li.insert(vecs[:40], auto_merge=False)
        same()
        for li in (tl, jl):
            li.delete([392, 400, 0, 9, 33])
        same()
        assert tl.merge() == jl.merge() == 1
        same()
        np.testing.assert_array_equal(tl._state.ext_of, jl._state.ext_of)
        mu = tl.lineage.pop("mu")
        np.testing.assert_allclose(mu, jl.lineage.pop("mu"), rtol=1e-4)
        assert tl.lineage == jl.lineage
    finally:
        tl.close()
        jl.close()


# ------------------------------------------------------- shared filter words


@pytest.mark.parametrize("n", [300, 320])
def test_shared_filter_packs_once(n):
    """A shared (n,) mask packs into one row of words, expanded to (Q, W):
    bit-identical to packing the broadcast (Q, n) mask; a (Q, n) mask packs
    as before; a mask of the wrong width is refused."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    adj = tbuild.random_graph(n, 4, torch.Generator().manual_seed(0))
    eng = tserving.SearchEngine(
        tserving.ExactBackend(T(x), adj, torch.tensor(0, dtype=torch.int32),
                              device="cpu"))
    allowed = rng.random(n) < 0.7
    want = tsearch.pack_filter(np.broadcast_to(allowed, (7, n)), n, "cpu")
    got = eng._pack_filter(allowed, 7)
    assert got.shape == want.shape and torch.equal(got, want)
    per_query = rng.random((7, n)) < 0.5
    assert torch.equal(eng._pack_filter(per_query, 7),
                       tsearch.pack_filter(per_query, n, "cpu"))
    with pytest.raises(ValueError):
        eng._pack_filter(allowed[:-1], 7)
    # The engine's filtered search with the shared mask.
    res = eng.search(x[:7], filter=allowed)
    ok = res.ids >= 0
    assert allowed[res.ids[ok]].all()


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_live_index_on_the_card(cuda, tmp_path):
    """The write path on the card: inserts found at rank 0 with d2 = 0,
    deletes never returned, a merge under traffic with stable ids, and the
    delta scan equal to the plain scan on the same rows."""
    x, q = _corpus()
    li = LiveIndex(x, CFG, k=5, beam_width=32, max_hops=64, m_pq=4,
                   merge_threshold=10_000, store_dir=tmp_path, device=cuda)
    try:
        rng = np.random.default_rng(11)
        vecs = rng.standard_normal((150, D)).astype(np.float32)
        ids = li.insert(vecs, auto_merge=False)
        own, d2 = li.search(vecs)
        np.testing.assert_array_equal(own[:, 0], ids)
        assert (d2[:, 0] == 0).all()
        li.delete(np.concatenate([ids[:20], np.arange(10)]))
        gone = np.concatenate([ids[:20], np.arange(10)])
        delta = li._state.delta
        got = delta.delta_topk(q, 10)
        live = np.flatnonzero(~delta.tombstone[390:]) + 390
        d, pos = tdist.brute_force_topk(T(q), delta.x.cpu()[live], 10)
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      live[pos.numpy()])
        torch.testing.assert_close(got[1].cpu(), d, rtol=1e-4, atol=1e-4)
        t = li.merge_async()
        while t.is_alive():
            ext, _ = li.search(q)
            assert not np.isin(ext, gone).any()
        t.join(timeout=300)
        assert li.generation == 1
        # At the merge boundary the walk alone answers: each vector it
        # finds keeps its external id.
        own, d2 = li.search(vecs[20:])
        hit = d2[:, 0] == 0
        np.testing.assert_array_equal(own[hit, 0], ids[20:][hit])
        assert hit.mean() >= 0.9
    finally:
        li.close()
