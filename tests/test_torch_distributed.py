"""The port's distributed MCGI path (``repro_torch.distributed``, the
engine's ``DistributedBackend``, the per-shard fits and configs, the
launcher's ``--distributed``) against the reference.

The reference's mesh programs need 8 XLA devices, which a process that has
already imported JAX cannot get.  So this file runs itself as a subprocess
(``python tests/test_torch_distributed.py ref OUT.npz``) that sets
``XLA_FLAGS`` before it imports JAX, builds the reference's sharded index on
a (2, 4) mesh and writes every reference output to one ``.npz``; its top
level imports neither JAX nor ``repro``.

* Integer data (vectors, queries and codebook rounded, codes re-encoded by
  the reference) makes every float32 sum exact: merges (both modes, with
  ties and a dead shard), searches, probe states, continues, engine results
  and per-shard fits must be bit-identical to the reference's.
* The reference's scenarios (``tests/_distributed_worker.py``) run on the
  port's own build over float data from numpy seeds, with the reference's
  bounds.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = ((2, 4), ("data", "model"))
S = 8
N, D, NQ, K, M_PQ = 512, 8, 24, 5, 4
PER = N // S
BEAM, MAX_HOPS, CHUNK = 16, 32, 8
BUILD_KW = dict(degree=8, beam_width=16, iters=1, batch=64, max_hops=32)
BUDGET_KW = dict(l_min=4, l_max=16, lam=0.35, probe_hops=4, hop_factor=2,
                 center=6.0)
LAWS = (np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8], np.float32),
        np.array([4, 2, 4, 8, 4, 2, 8, 4], np.int32))
# distributed_search variants: (name, kwargs); "laws" / "dead" are extras.
SEARCHES = {
    "fixed_hier": dict(),
    "fixed_exact_flat_dead": dict(use_pq=False, merge="flat", dead=3),
    "adaptive_centered": dict(budget=True, center=None),
    "adaptive_buckets_laws": dict(budget=True, budget_buckets=4, laws=True),
    "adaptive_exact_flat_buckets_dead": dict(budget=True, use_pq=False,
                                             merge="flat", budget_buckets=4,
                                             dead=5),
}
SUBSET = [0, 2, 3, 7, 11, 12, 20]
CALIB_BASE = dict(l_min=8, l_max=16, lam=0.0, probe_hops=4, hop_factor=1)
CALIB_TARGET, CALIB_SAMPLE = 0.97, 16


def _search_kw(spec: dict) -> dict:
    kw = dict(beam_width=BEAM, max_hops=MAX_HOPS, k=K, query_chunk=CHUNK,
              use_pq=spec.get("use_pq", True),
              merge=spec.get("merge", "hierarchical"))
    if spec.get("budget_buckets"):
        kw["budget_buckets"] = spec["budget_buckets"]
    return kw


def _budget_kw(spec: dict) -> dict:
    return {**BUDGET_KW, **({"center": spec["center"]}
                            if "center" in spec else {})}


def _candidates():
    """Per-shard (S, Q, k) merge candidates, rows ascending, heavy ties."""
    rng = np.random.default_rng(11)
    d2 = np.sort(rng.integers(0, 4, (S, NQ, K)), axis=-1).astype(np.float32)
    ids = rng.integers(0, PER, (S, NQ, K)).astype(np.int32)
    ok = np.ones(S, bool)
    ok[3] = False
    return d2, ids, ok


def _integer_data():
    rng = np.random.default_rng(0)
    x = np.round(rng.standard_normal((N, D)) * 4).astype(np.float32)
    q = np.round(rng.standard_normal((NQ, D)) * 4).astype(np.float32)
    return x, q


# ------------------------------------------------- the reference's side


def _reference(out_path: str) -> None:
    """Build the reference's sharded index on 8 virtual devices and write
    every reference output this file compares against."""
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat, serving
    from repro.configs import mcgi_datasets as cfgs
    from repro.core import build, calibrate
    from repro.core.search import AdaptiveBeamBudget
    from repro.distributed import sharded_search as ss
    from repro.pq import PqCodebook, pq_encode

    mesh = compat.make_mesh(*MESH)
    axes = MESH[1]
    row = NamedSharding(mesh, P(axes, None))
    flag = NamedSharding(mesh, P(axes))
    out: dict = {}
    x, q = _integer_data()
    arrays, per = ss.build_sharded_arrays(
        jnp.asarray(x), mesh, build_cfg=build.BuildConfig(**BUILD_KW),
        m_pq=M_PQ)
    assert per == PER
    book = PqCodebook(jnp.round(arrays["centroids"]))
    arrays["centroids"] = jax_put(book.centroids, NamedSharding(mesh, P()))
    arrays["codes"] = jax_put(pq_encode(jnp.asarray(x), book), row)
    for name, a in arrays.items():
        out[f"arr_{name}"] = np.asarray(a)
    out["q"] = q
    # Where each shard's rows live: its device's position in the mesh.
    devs = list(mesh.devices.flat)
    place = np.full(S, -1)
    for sh in arrays["vectors"].addressable_shards:
        place[(sh.index[0].start or 0) // PER] = devs.index(sh.device)
    out["placement"] = place
    ok_all = jnp.ones((S,), jnp.bool_)

    def dead(s):
        return jax_put(ok_all.at[s].set(False), flag)

    # Merges, both modes, on tie-heavy candidates with a dead shard.
    d2c, idc, okc = _candidates()
    for mode in ("flat", "hierarchical"):
        def fn(d2_l, ids_l, ok_l, mode=mode):
            return ss._hedged_merge(d2_l[0], ids_l[0], ok_l, mesh, axes,
                                    mode)

        got = compat.shard_map(
            fn, mesh=mesh, in_specs=(P(axes), P(axes), P(axes)),
            out_specs=(P(), P(), P()))(
                jnp.asarray(d2c), jnp.asarray(idc), jnp.asarray(okc))
        for name, a in zip(("d2", "sid", "lid"), got):
            out[f"merge_{mode}_{name}"] = np.asarray(a)

    for name, spec in SEARCHES.items():
        kw = _search_kw(spec)
        if spec.get("budget"):
            kw["beam_budget"] = AdaptiveBeamBudget(**_budget_kw(spec))
        got = ss.distributed_search(
            mesh, arrays, jnp.asarray(q),
            shard_ok=dead(spec["dead"]) if "dead" in spec else None,
            shard_laws=LAWS if spec.get("laws") else None, **kw)
        for part, a in zip(("d2", "sid", "lid"), got):
            out[f"search_{name}_{part}"] = np.asarray(a)

    budget = AdaptiveBeamBudget(**BUDGET_KW)
    probe = ss.make_distributed_probe(
        mesh, budget_cfg=budget, max_hops=MAX_HOPS, query_chunk=CHUNK,
        budget_buckets=4, per_shard_laws=True)
    laws = (jax_put(jnp.asarray(LAWS[0]), flag),
            jax_put(jnp.asarray(LAWS[1]), flag))
    for tag, qq in (("ragged", q[:13]), ("full", q)):
        st, b, h, lid = probe(arrays["adj"], arrays["codes"],
                              arrays["vectors"], arrays["centroids"],
                              jnp.asarray(qq), arrays["entries"], *laws)
        for i, a in enumerate(tuple(st) + (b, h, lid)):
            out[f"probe_{tag}_{i}"] = np.asarray(a)
    cont = ss.make_distributed_continue(mesh, budget_cfg=budget, k=K)
    sel = jnp.asarray(SUBSET)
    got = cont(arrays["adj"], arrays["codes"], arrays["vectors"],
               arrays["centroids"], tuple(a[sel] for a in st),
               jnp.asarray(q)[sel], b[sel], h[sel], dead(5))
    for i, a in enumerate(got):
        out[f"continue_{i}"] = np.asarray(a)

    # The engine: staged, monolithic, stream, permutation, coalescing,
    # identity laws and the mid-stream fault.
    def backend(**kw):
        return serving.DistributedBackend(
            mesh, arrays, beam_width=BEAM, max_hops=MAX_HOPS, k=K,
            query_chunk=CHUNK, beam_budget=budget, budget_buckets=4, **kw)

    def keep(tag, res):
        out[f"eng_{tag}_ids"] = np.asarray(res.ids)
        out[f"eng_{tag}_d2"] = np.asarray(res.d2)
        if res.stats is not None:
            out[f"eng_{tag}_hops"] = np.asarray(res.stats.hops)
            out[f"eng_{tag}_evals"] = np.asarray(res.stats.dist_evals)
            out[f"eng_{tag}_budget"] = np.asarray(res.astats.budget)
            out[f"eng_{tag}_sid"] = np.asarray(res.extras["shard_ids"])

    staged = serving.SearchEngine(backend(), budget, k=K, num_buckets="auto")
    keep("staged", staged.search(q))
    keep("mono", serving.SearchEngine(backend(), None, k=K).search(q))
    for i, res in enumerate(staged.search_batches(_stream_batches(q))):
        keep(f"piped{i}", res)
    perm = np.random.default_rng(7).permutation(NQ)
    keep("perm", staged.search(q[perm]))
    coal = serving.SearchEngine(backend(), budget, k=K, num_buckets="auto",
                                coalesce_lanes=12)
    for i, res in enumerate(coal.search_batches(
            [q[i:i + 4] for i in range(0, NQ, 4)])):
        keep(f"coal{i}", res)
    ident = (np.full(S, budget.lam, np.float32),
             np.full(S, budget.l_min, np.int32))
    keep("ident", serving.SearchEngine(backend(shard_laws=ident), budget,
                                       k=K, num_buckets="auto").search(q))
    fb = backend()
    eng = serving.SearchEngine(fb, budget, k=K, num_buckets=None)
    for i, res in enumerate(eng.search_batches([q[:8]] * 6)):
        keep(f"fault{i}", res)
        if i == 1:
            fb.set_shard_ok(dead(3))

    # Per-shard fits, the shard medoids of float rows, configs and specs.
    fit = calibrate.calibrate_budget_law_per_shard(
        calibrate.shard_exact_recall_evals(
            out["arr_vectors"], out["arr_adj"], out["arr_entries"], q, S,
            k=K, sample=CALIB_SAMPLE),
        AdaptiveBeamBudget(**CALIB_BASE), CALIB_TARGET, S)
    out["fit"] = np.array(json.dumps(dataclasses.asdict(fit)))
    xf = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    out["xf"] = xf
    out["medoids"] = np.asarray(ss.shard_medoids(jnp.asarray(xf), S))
    c = cfgs._DATASETS[0]
    out["laws_identity"] = np.stack(c.shard_budget_laws(S)).astype(
        np.float32)
    stored = dataclasses.replace(c, shard_lam=tuple(LAWS[0].tolist()),
                                 shard_l_min=tuple(LAWS[1].tolist()))
    out["laws_stored"] = np.stack(stored.shard_budget_laws(S)).astype(
        np.float32)
    specs = ss.sharded_index_specs(mesh, n=1000, d=12, degree=6, m_pq=4,
                                   n_queries=7, per_shard_laws=True)
    out["specs"] = np.array(json.dumps({
        f.name: [list(getattr(specs, f.name).shape),
                 str(getattr(specs, f.name).dtype)]
        for f in dataclasses.fields(specs)}))
    np.savez(out_path, **out)


def jax_put(a, sharding):
    import jax

    return jax.device_put(a, sharding)


def _stream_batches(q):
    return [q[:8], q[8:19], q[19:]]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, built once in a subprocess with 8 virtual
    XLA devices (bounded wait)."""
    path = tmp_path_factory.mktemp("dist") / "ref.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, __file__, "ref", str(path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------ the port's side


torch.set_num_threads(1)
if __name__ != "__main__":
    from repro_torch import serving as tserving
    from repro_torch.configs import mcgi_datasets as tconfigs
    from repro_torch.core import build as tbuild
    from repro_torch.core import calibrate as tcal
    from repro_torch.core import distance as tdist
    from repro_torch.core import search as tsearch
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed import sharded_search as tss
    from repro_torch.index import convert
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.serving import server


def _mesh(device="cpu"):
    return make_mesh(*MESH, device=device)


def _listed_mesh():
    """The mesh over an explicit list of 8 CPU device entries: a spread
    mesh, whose index is held as one block of rows a shard."""
    return make_mesh(*MESH, devices=["cpu"] * S)


def _budget(**kw):
    return tsearch.AdaptiveBeamBudget(**{**BUDGET_KW, **kw})


def _port_arrays(ref, mesh=None) -> dict:
    """The reference's index: shard-major on the CPU, or placed on
    ``mesh``."""
    return convert.sharded_arrays_from_arrays(
        {k[4:]: v for k, v in ref.items() if k.startswith("arr_")},
        "cpu" if mesh is None else mesh)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _backend(arrays, device="cpu", mesh=None, **kw):
    return tserving.DistributedBackend(
        mesh or _mesh(device), arrays, beam_width=BEAM, max_hops=MAX_HOPS,
        k=K, query_chunk=CHUNK, beam_budget=kw.pop("budget", _budget()),
        budget_buckets=4, **kw)


# ------------------------------------------- bit-identical to the reference


def test_convert_carries_the_sharded_index(ref):
    port = _port_arrays(ref)
    assert set(port) == {"adj", "codes", "vectors", "centroids", "entries"}
    for name, t in port.items():
        _same(t, ref[f"arr_{name}"])
    assert port["codes"].dtype == torch.uint8


@pytest.mark.parametrize("mode", ["flat", "hierarchical"])
def test_hedged_merge_bit_identical_with_ties_and_a_dead_shard(ref, mode):
    d2, ids, ok = _candidates()
    got = tss._hedged_merge(torch.from_numpy(d2), torch.from_numpy(ids),
                            torch.from_numpy(ok), _mesh(), MESH[1], mode)
    for g, part in zip(got, ("d2", "sid", "lid")):
        _same(g, ref[f"merge_{mode}_{part}"])
    assert (got[1].numpy() != 3).all() or np.isinf(got[0].numpy()).all()


def _check_search(ref, name, mesh=None):
    spec = SEARCHES[name]
    kw = _search_kw(spec)
    if spec.get("budget"):
        kw["beam_budget"] = tsearch.AdaptiveBeamBudget(**_budget_kw(spec))
    ok = None
    if "dead" in spec:
        ok = np.ones(S, bool)
        ok[spec["dead"]] = False
    got = tss.distributed_search(
        mesh or _mesh(), _port_arrays(ref, mesh), ref["q"], shard_ok=ok,
        shard_laws=LAWS if spec.get("laws") else None, **kw)
    for g, part in zip(got, ("d2", "sid", "lid")):
        _same(g, ref[f"search_{name}_{part}"])
    if "dead" in spec:
        assert (got[1].numpy() != spec["dead"]).all()


@pytest.mark.parametrize("name", list(SEARCHES))
def test_distributed_search_bit_identical(ref, name):
    _check_search(ref, name)


@pytest.mark.parametrize("name", list(SEARCHES))
def test_distributed_search_bit_identical_on_a_device_list(ref, name):
    _check_search(ref, name, _listed_mesh())


def _check_probe(ref, tag, nq, mesh=None):
    """The (Q, S, ...) probe state (visited words as uint32 patterns, the
    shared context), per-shard budgets, hop limits and LID."""
    a = _port_arrays(ref, mesh)
    probe = tss.make_distributed_probe(
        mesh or _mesh(), budget_cfg=_budget(), max_hops=MAX_HOPS,
        query_chunk=CHUNK, budget_buckets=4, per_shard_laws=True)
    st, b, h, lid = probe(a["adj"], a["codes"], a["vectors"],
                          a["centroids"], torch.from_numpy(ref["q"][:nq]),
                          a["entries"], torch.from_numpy(LAWS[0]),
                          torch.from_numpy(LAWS[1]))
    outs = tuple(st) + (b, h)
    assert len(outs) == 9 and st[3].shape == (nq, S, (PER + 31) // 32)
    for i, g in enumerate(outs):
        _same(g, ref[f"probe_{tag}_{i}"])
    # The online LID's last bit may differ between the frameworks (a log
    # summed in another order); the reference's LID tolerance holds it.
    np.testing.assert_allclose(lid.numpy(), ref[f"probe_{tag}_9"],
                               rtol=1e-4)
    return st


@pytest.mark.parametrize("tag,nq", [("full", NQ), ("ragged", 13)])
def test_probe_state_bit_identical(ref, tag, nq):
    _check_probe(ref, tag, nq)


@pytest.mark.parametrize("tag,nq", [("full", NQ), ("ragged", 13)])
def test_probe_state_bit_identical_on_a_device_list(ref, tag, nq):
    """Each shard's block of the state stays a block of its own."""
    mesh = _listed_mesh()
    st = _check_probe(ref, tag, nq, mesh)
    for leaf in st[:6]:
        assert isinstance(leaf, tss.ShardStack) and len(leaf.parts) == S
        assert all(p.shape[0] == nq for p in leaf.parts)


def _check_continue(ref, mesh=None):
    a = _port_arrays(ref, mesh)
    mesh = mesh or _mesh()
    probe = tss.make_distributed_probe(
        mesh, budget_cfg=_budget(), max_hops=MAX_HOPS, query_chunk=CHUNK,
        budget_buckets=4, per_shard_laws=True)
    q = torch.from_numpy(ref["q"])
    st, b, h, _ = probe(a["adj"], a["codes"], a["vectors"], a["centroids"],
                        q, a["entries"], torch.from_numpy(LAWS[0]),
                        torch.from_numpy(LAWS[1]))
    cont = tss.make_distributed_continue(mesh, budget_cfg=_budget(), k=K)
    sel = torch.tensor(SUBSET)
    ok = torch.ones(S, dtype=torch.bool)
    ok[5] = False
    got = cont(a["adj"], a["codes"], a["vectors"], a["centroids"],
               tuple(t[sel] for t in st), q[sel], b[sel], h[sel], ok)
    for i, g in enumerate(got):
        _same(g, ref[f"continue_{i}"])


def test_continue_on_a_lane_subset_bit_identical(ref):
    _check_continue(ref)


def test_continue_on_a_lane_subset_bit_identical_on_a_device_list(ref):
    _check_continue(ref, _listed_mesh())


def _keep_same(res, ref, tag):
    _same(res.ids, ref[f"eng_{tag}_ids"])
    _same(res.d2, ref[f"eng_{tag}_d2"])
    if f"eng_{tag}_hops" in ref:
        _same(res.stats.hops, ref[f"eng_{tag}_hops"])
        _same(res.stats.dist_evals, ref[f"eng_{tag}_evals"])
        _same(res.astats.budget, ref[f"eng_{tag}_budget"])
        _same(res.extras["shard_ids"], ref[f"eng_{tag}_sid"])


def _check_engines(ref, mesh=None):
    a, q = _port_arrays(ref, mesh), ref["q"]
    staged = tserving.SearchEngine(_backend(a, mesh=mesh), _budget(), k=K,
                                   num_buckets="auto")
    rs = staged.search(q)
    _keep_same(rs, ref, "staged")
    rm = tserving.SearchEngine(_backend(a, mesh=mesh), None, k=K).search(q)
    _keep_same(rm, ref, "mono")
    np.testing.assert_array_equal(rs.ids, rm.ids)
    np.testing.assert_array_equal(rs.d2, rm.d2)
    ident = (np.full(S, BUDGET_KW["lam"], np.float32),
             np.full(S, BUDGET_KW["l_min"], np.int32))
    rl = tserving.SearchEngine(_backend(a, mesh=mesh, shard_laws=ident),
                               _budget(), k=K, num_buckets="auto").search(q)
    _keep_same(rl, ref, "ident")
    np.testing.assert_array_equal(rl.ids, rs.ids)
    np.testing.assert_array_equal(rl.d2, rs.d2)


def test_engine_staged_monolithic_and_identity_laws_bit_identical(ref):
    _check_engines(ref)


def test_engine_staged_monolithic_and_identity_laws_on_a_device_list(ref):
    _check_engines(ref, _listed_mesh())


def test_engine_stream_permutation_and_coalescing_bit_identical(ref):
    a, q = _port_arrays(ref), ref["q"]
    staged = tserving.SearchEngine(_backend(a), _budget(), k=K,
                                   num_buckets="auto")
    batches = _stream_batches(q)
    for i, (res, b) in enumerate(zip(staged.search_batches(batches),
                                     batches)):
        _keep_same(res, ref, f"piped{i}")
        eager = staged.search(b)
        np.testing.assert_array_equal(res.ids, eager.ids)
        np.testing.assert_array_equal(res.d2, eager.d2)
    perm = np.random.default_rng(7).permutation(NQ)
    rp = staged.search(q[perm])
    _keep_same(rp, ref, "perm")
    np.testing.assert_array_equal(rp.ids[np.argsort(perm)],
                                  staged.search(q).ids)
    coal = tserving.SearchEngine(_backend(a), _budget(), k=K,
                                 num_buckets="auto", coalesce_lanes=12)
    micro = [q[i:i + 4] for i in range(0, NQ, 4)]
    res_c = list(coal.search_batches(micro))
    assert len(res_c) == len(micro)
    for i, (res, b) in enumerate(zip(res_c, micro)):
        _keep_same(res, ref, f"coal{i}")
        np.testing.assert_array_equal(res.ids, staged.search(b).ids)


def test_engine_zero_query_batch_keeps_the_distributed_shapes(ref):
    eng = tserving.SearchEngine(_backend(_port_arrays(ref)), _budget(), k=K)
    r0 = eng.search(ref["q"][:0])
    assert r0.ids.shape == (0, K) and r0.d2.shape == (0, K)
    assert r0.extras["shard_ids"].shape == (0, K)
    assert r0.stats.hops.shape == (0,)
    mono = tserving.SearchEngine(_backend(_port_arrays(ref)), None, k=K)
    assert mono.search(ref["q"][:0]).extras["shard_ids"].shape == (0, K)


def _check_fault(ref, mesh=None):
    fb = _backend(_port_arrays(ref, mesh), mesh=mesh)
    eng = tserving.SearchEngine(fb, _budget(), k=K, num_buckets=None)
    dead = np.ones(S, bool)
    dead[3] = False
    results = []
    for i, res in enumerate(eng.search_batches([ref["q"][:8]] * 6)):
        results.append(res)
        _keep_same(res, ref, f"fault{i}")
        if i == 1:
            fb.set_shard_ok(dead)
    assert (results[-1].extras["shard_ids"] != 3).all()
    assert np.isfinite(results[-1].d2).all()


def test_engine_mid_stream_fault_bit_identical(ref):
    _check_fault(ref)


def test_engine_mid_stream_fault_bit_identical_on_a_device_list(ref):
    _check_fault(ref, _listed_mesh())


def test_shard_medoids_match_reference(ref):
    got = tss.shard_medoids(torch.from_numpy(ref["xf"]), S)
    _same(got, ref["medoids"])
    assert got.dtype == torch.int32


def test_per_shard_fits_match_reference(ref):
    """Every shard's joint fit, with its whole history, equals the
    reference's on integer data (no claim that per-shard fits are tighter
    than a global one)."""
    a = _port_arrays(ref)
    fit = tcal.calibrate_budget_law_per_shard(
        tcal.shard_exact_recall_evals(a["vectors"], a["adj"], a["entries"],
                                      ref["q"], S, k=K, sample=CALIB_SAMPLE,
                                      device="cpu"),
        tsearch.AdaptiveBeamBudget(**CALIB_BASE), CALIB_TARGET, S)
    want = json.loads(str(ref["fit"]))
    got = json.loads(json.dumps(dataclasses.asdict(fit)))
    assert got == want
    lam, l_min = fit.law_arrays()
    assert lam.dtype == np.float32 and l_min.dtype == np.int32
    assert lam.shape == l_min.shape == (S,)
    base = tsearch.AdaptiveBeamBudget(**CALIB_BASE)
    assert fit.serving_budget(base).hop_factor == max(fit.hop_factor)
    assert fit.achieved == all(r.achieved for r in fit.results)


def test_shard_budget_laws_match_reference(ref):
    c = tconfigs.DATASETS["mcgi-sift1m"]
    lam, l_min = c.shard_budget_laws(S)
    assert lam.dtype == np.float32 and l_min.dtype == np.int32
    np.testing.assert_array_equal(np.stack([lam, l_min]).astype(np.float32),
                                  ref["laws_identity"])
    stored = dataclasses.replace(c, shard_lam=tuple(LAWS[0].tolist()),
                                 shard_l_min=tuple(LAWS[1].tolist()))
    np.testing.assert_array_equal(
        np.stack(stored.shard_budget_laws(S)).astype(np.float32),
        ref["laws_stored"])
    with pytest.raises(ValueError):
        stored.shard_budget_laws(4)


def test_sharded_index_specs_match_reference(ref):
    specs = tss.sharded_index_specs(_mesh(), n=1000, d=12, degree=6, m_pq=4,
                                    n_queries=7, per_shard_laws=True)
    want = json.loads(str(ref["specs"]))
    for f in dataclasses.fields(specs):
        t = getattr(specs, f.name)
        assert t.device.type == "meta"
        shape, dtype = want[f.name]
        assert list(t.shape) == shape, f.name
        assert str(t.dtype).replace("torch.", "") == {
            "bool": "bool", "uint8": "uint8"}.get(dtype, dtype), f.name
    plain = tss.sharded_index_specs(_mesh(), n=1000, d=12, degree=6,
                                    m_pq=None, n_queries=7)
    assert plain.shard_lam is None and plain.codes.shape == (1000, 1)


# ------------------------------------- the reference's scenarios, on the port


def _float_world(n, d, nq, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _recall(ids, gt):
    return float(tdist.recall_at_k(torch.as_tensor(np.asarray(ids)),
                                   torch.as_tensor(np.asarray(gt))))


def test_sharded_search_recall_and_hedging():
    """``scenario_sharded_search``: recall >= 0.85; dropping 1 of 8 shards
    costs at most 0.2 and returns nothing from it."""
    x, q = _float_world(2048, 32, 64)
    mesh = _mesh()
    arrays, per = tss.build_sharded_arrays(
        x, mesh, build_cfg=tbuild.BuildConfig(degree=12, beam_width=32,
                                              iters=1, batch=128,
                                              max_hops=64), m_pq=8)
    _, gt = tdist.brute_force_topk(torch.from_numpy(q), torch.from_numpy(x),
                                   10)
    kw = dict(beam_width=32, max_hops=64, k=10, query_chunk=16, use_pq=True)
    _, sid, lid = tss.distributed_search(mesh, arrays, q, **kw)
    recall = _recall(sid * per + lid, gt)
    ok = np.ones(S, bool)
    ok[3] = False
    _, sb, lb = tss.distributed_search(mesh, arrays, q, shard_ok=ok, **kw)
    assert recall >= 0.85, recall
    assert _recall(sb * per + lb, gt) >= recall - 0.2
    assert int((sb == 3).sum()) == 0


def test_merge_modes_agree():
    """``scenario_merge_modes``: flat and hierarchical give the same ids
    and d2 on float data."""
    x, q = _float_world(1024, 16, 32, seed=1)
    mesh = _mesh()
    arrays, per = tss.build_sharded_arrays(
        x, mesh, build_cfg=tbuild.BuildConfig(degree=8, beam_width=16,
                                              iters=1, batch=128,
                                              max_hops=32), m_pq=4,
        pq_iters=3)
    outs = {mode: tss.distributed_search(
        mesh, arrays, q, beam_width=16, max_hops=32, k=5, query_chunk=8,
        use_pq=True, merge=mode) for mode in ("flat", "hierarchical")}
    f, h = outs["flat"], outs["hierarchical"]
    np.testing.assert_array_equal(f[1] * per + f[2], h[1] * per + h[2])
    np.testing.assert_allclose(f[0].numpy(), h[0].numpy())


@pytest.fixture(scope="module")
def scenario():
    """``scenario_staged_engine``'s world on the port's own build."""
    x, q = _float_world(2048, 32, 48, seed=2)
    mesh = _mesh()
    arrays, per = tss.build_sharded_arrays(
        x, mesh, build_cfg=tbuild.BuildConfig(degree=12, beam_width=32,
                                              iters=1, batch=128,
                                              max_hops=64), m_pq=8)
    _, gt = tdist.brute_force_topk(torch.from_numpy(q), torch.from_numpy(x),
                                   10)
    budget = tsearch.AdaptiveBeamBudget(l_min=8, l_max=32, lam=0.35,
                                        center=8.0)
    return dict(mesh=mesh, arrays=arrays, per=per, q=q, gt=gt.numpy(),
                budget=budget)


def _scenario_backend(sc, **kw):
    return tserving.DistributedBackend(
        sc["mesh"], sc["arrays"], beam_width=32, max_hops=64, k=10,
        query_chunk=16, beam_budget=sc["budget"], budget_buckets=4, **kw)


def test_staged_engine_parity(scenario):
    """``scenario_staged_engine`` on the port: staged == monolithic,
    pipelined == eager with ragged tails, permutation invariance,
    coalescing, identity per-shard laws, a zero-query batch."""
    sc, q, budget = scenario, scenario["q"], scenario["budget"]
    staged = tserving.SearchEngine(_scenario_backend(sc), budget, k=10,
                                   num_buckets="auto")
    mono = tserving.SearchEngine(_scenario_backend(sc), None, k=10)
    rs, rm = staged.search(q), mono.search(q)
    assert (rs.ids == rm.ids).all() and (rs.d2 == rm.d2).all()
    batches = [q[:16], q[16:35], q[35:]]
    for p, b in zip(staged.search_batches(batches), batches):
        e = staged.search(b)
        assert (p.ids == e.ids).all() and (p.d2 == e.d2).all()
    r0 = staged.search(q[:0])
    assert r0.ids.shape == (0, 10) and r0.extras["shard_ids"].shape == (0, 10)
    perm = np.random.default_rng(7).permutation(q.shape[0])
    assert (staged.search(q[perm]).ids[np.argsort(perm)] == rs.ids).all()
    coal = tserving.SearchEngine(_scenario_backend(sc), budget, k=10,
                                 num_buckets="auto", coalesce_lanes=24)
    micro = [q[i:i + 8] for i in range(0, 48, 8)]
    res_c = list(coal.search_batches(micro))
    assert len(res_c) == len(micro)
    assert all((c.ids == staged.search(b).ids).all()
               for c, b in zip(res_c, micro))
    laws = (np.full(S, budget.lam, np.float32),
            np.full(S, budget.l_min, np.int32))
    rl = tserving.SearchEngine(_scenario_backend(sc, shard_laws=laws),
                               budget, k=10, num_buckets="auto").search(q)
    assert (rl.ids == rs.ids).all() and (rl.d2 == rs.d2).all()


def test_staged_fault_injection_mid_stream(scenario):
    """``set_shard_ok`` flipped between batches of a pipelined stream: the
    last batch excludes the dead shard, stays finite, and loses at most the
    shard's data fraction plus 0.08 of recall."""
    sc, q = scenario, scenario["q"]
    fb = _scenario_backend(sc)
    eng = tserving.SearchEngine(fb, sc["budget"], k=10, num_buckets=None)
    dead = np.ones(S, bool)
    dead[3] = False
    results = []
    for i, res in enumerate(eng.search_batches([q[:16]] * 6)):
        results.append(res)
        if i == 1:
            fb.set_shard_ok(dead)
    gt = sc["gt"][:16]
    r_before, r_after = _recall(results[0].ids, gt), _recall(
        results[-1].ids, gt)
    assert (results[-1].extras["shard_ids"] != 3).all()
    assert np.isfinite(results[-1].d2).all()
    assert r_after >= r_before - 1.0 / S - 0.08, (r_before, r_after)


def test_front_door_over_distributed_backend():
    """``scenario_front_door`` on the port: lanes bit-identical to a direct
    search, no partial support, a shard flip between dispatches removes its
    ids from later lanes, a wedged dispatch times out and the open-lane
    bound sheds."""
    import math

    x, q = _float_world(1024, 16, 32, seed=3)
    mesh = _mesh()
    arrays, _ = tss.build_sharded_arrays(
        x, mesh, build_cfg=tbuild.BuildConfig(degree=8, beam_width=16,
                                              iters=1, batch=128,
                                              max_hops=32), m_pq=4)
    budget = tsearch.AdaptiveBeamBudget(l_min=8, l_max=16, lam=0.35,
                                        center=8.0)
    fb = tserving.DistributedBackend(mesh, arrays, beam_width=16,
                                     max_hops=32, k=5, query_chunk=8,
                                     beam_budget=budget, budget_buckets=4)
    eng = tserving.SearchEngine(fb, budget, k=5, num_buckets=None)
    assert not eng.supports_partial
    clock = server.VirtualClock()
    door = server.FrontDoor(
        {"c": eng}, [server.QoSClass("c", deadline_s=60.0,
                                     batch_window_s=0.01, max_lanes=8)],
        clock=clock, dispatcher=server.VirtualDispatcher(clock))
    want = eng.search(q[:8])
    futs = [door.submit(q[i]) for i in range(8)]
    clock.advance(0.1)
    rows = [f.result(timeout=0) for f in futs]
    assert all(r.status == "ok" for r in rows)
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(r.ids, want.ids[i])
        np.testing.assert_array_equal(r.d2, want.d2[i])
    dead = np.ones(S, bool)
    dead[3] = False
    fb.set_shard_ok(dead)
    futs2 = [door.submit(q[8 + i]) for i in range(8)]
    clock.advance(0.1)
    rows2 = [f.result(timeout=0) for f in futs2]
    assert all(r.status == "ok" for r in rows2)
    assert all((np.asarray(r.extras["shard_ids"]) != 3).all() for r in rows2)
    clock2 = server.VirtualClock()
    door2 = server.FrontDoor(
        {"c": eng}, [server.QoSClass("c", deadline_s=0.5,
                                     batch_window_s=0.0, max_lanes=4)],
        max_queue=8, clock=clock2,
        dispatcher=server.VirtualDispatcher(clock2, service_time=math.inf,
                                            probe_time=0.001))
    futs3 = [door2.submit(q[i % 16]) for i in range(12)]
    clock2.advance(1.0)
    st = door2.stats()
    assert st["timeout"] == 8 and st["partial"] == 0
    assert st["shed"] == 4 and st["max_open_lanes"] <= 8
    assert all(f.done() for f in futs3)


# --------------------------------------------- the backend's own contract


def test_backend_refuses_filters_partials_and_a_foreign_law(ref):
    a = _port_arrays(ref)
    back = _backend(a)
    eng = tserving.SearchEngine(back, _budget(), k=K)
    assert not eng.supports_partial and not hasattr(back, "partial_parts")
    with pytest.raises(NotImplementedError):
        back.probe(back.admit(ref["q"]), _budget(), excl=torch.zeros(1))
    with pytest.raises(ValueError):
        back.probe(back.admit(ref["q"]), _budget(lam=0.1))
    with pytest.raises(NotImplementedError):
        eng.search(ref["q"], filter=np.ones(N, bool))
    with pytest.raises(ValueError, match="partial"):
        eng.partial_result(eng.begin(ref["q"][:4]))
    mono = tserving.SearchEngine(_backend(a), None, k=K)
    with pytest.raises(NotImplementedError):
        mono.search(ref["q"], filter=np.ones(N, bool))
    assert back.launch_cost_hops == 512 * S and back.staged
    assert not _backend(a, budget=None).staged


def test_chunking_rules_raise_value_errors(ref):
    """The monolithic step takes whole query chunks; the probe takes a
    ragged batch as one chunk up to max(4 * query_chunk, 512) lanes."""
    a = _port_arrays(ref)
    with pytest.raises(ValueError, match="query_chunk"):
        tss.distributed_search(_mesh(), a, ref["q"][:13], beam_width=BEAM,
                               max_hops=MAX_HOPS, k=K, query_chunk=CHUNK)
    probe = tss.make_distributed_probe(_mesh(), budget_cfg=_budget(),
                                       max_hops=MAX_HOPS, query_chunk=2)
    big = torch.zeros((513, D))
    with pytest.raises(ValueError, match="chunk grid"):
        probe(a["adj"], a["codes"], a["vectors"], a["centroids"], big,
              a["entries"])


def test_mesh_names_its_axes_and_device():
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    assert mesh.n_shards == 8 and mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model")
    assert mesh.device == torch.device("cpu")
    for shape, names in (((2, 4), ("data",)), ((0,), ("data",)),
                         ((2, 2), ("a", "a"))):
        with pytest.raises(ValueError):
            make_mesh(shape, names, "cpu")


def test_mesh_places_shards_as_the_reference(ref):
    """A (2, 4) mesh over 8 devices puts shard s where the reference's
    ``NamedSharding(mesh, P(axes, None))`` puts its rows."""
    mesh = make_mesh(*MESH, devices=["cpu"] * S)
    assert list(mesh.placement) == ref["placement"].tolist()
    assert mesh.shard_devices == (torch.device("cpu"),) * S


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_mesh_spreads_shards_in_contiguous_blocks(n_dev):
    mesh = make_mesh(*MESH, devices=["cpu"] * n_dev)
    assert mesh.placement == tuple(s * n_dev // S for s in range(S))
    assert list(mesh.placement) == sorted(mesh.placement)
    assert [mesh.placement.count(p) for p in range(n_dev)] == \
        [S // n_dev] * n_dev
    assert mesh.spread == (n_dev > 1) and mesh.device == torch.device("cpu")
    assert mesh.streams == (None,) * S
    with pytest.raises(ValueError):
        make_mesh(*MESH, devices=["cpu"] * (S + 1))
    with pytest.raises(ValueError):
        make_mesh(*MESH, devices=["cpu"], device="cpu")


def test_placed_index_holds_one_block_a_shard(ref):
    """``place_arrays`` on a spread mesh: every shard's rows a block of its
    own, gathered back to the shard-major arrays on request; a one-device
    mesh's build stays shard-major."""
    mesh = _listed_mesh()
    a = _port_arrays(ref, mesh)
    for name in ("adj", "codes", "vectors", "entries"):
        t = a[name]
        assert isinstance(t, tss.ShardedRows) and len(t.parts) == S
        assert t.shape == ref[f"arr_{name}"].shape
        _same(t.gather(), ref[f"arr_{name}"])
    assert a["entries"].parts[0].shape == (1,)
    assert tss.place_arrays(mesh, a)["adj"] is a["adj"]
    with pytest.raises(ValueError, match="place the index"):
        tss.distributed_search(mesh, {**a, "adj": torch.zeros(
            (N, 8), dtype=torch.int32, device="meta")}, ref["q"],
            beam_width=BEAM, max_hops=MAX_HOPS, k=K, query_chunk=CHUNK)


def test_build_sharded_arrays_builds_each_shard_alone():
    """Every shard's adjacency is the port's own ``build_with_alpha`` on
    its slice (shard-local ids), entries are ``shard_medoids``, and a
    ragged row count is cut to the shard grid."""
    x, _ = _float_world(8 * 40 + 5, 8, 1, seed=4)
    cfg = tbuild.BuildConfig(degree=6, beam_width=12, iters=1, batch=32,
                             max_hops=24)
    t: dict = {}
    arrays, per = tss.build_sharded_arrays(x, _mesh(), build_cfg=cfg,
                                           m_pq=4, timings=t)
    assert per == 40 and arrays["vectors"].shape == (320, 8)
    assert set(t) == {f"shard_{s}" for s in range(S)} | {"pq"}
    xt = torch.from_numpy(x[:320])
    for s in range(S):
        want = tbuild.build_with_alpha(
            xt[s * per:(s + 1) * per], torch.full((per,), 1.2), cfg)
        assert torch.equal(arrays["adj"][s * per:(s + 1) * per], want)
    assert torch.equal(arrays["entries"], tss.shard_medoids(xt, S))
    assert int(arrays["adj"].max()) < per


# ----------------------------------------------------------- the launcher


TINY = ["--device", "cpu", "--n", "600", "--degree", "12", "--l-build",
        "24", "--batch", "16", "--num-batches", "2", "--build-batch", "64"]


def test_launcher_distributed_serves(capsys):
    tserve.main(TINY + ["--distributed", "4", "--adaptive", "--pipeline"])
    out = capsys.readouterr().out
    assert "600 points over 4 shards (150/shard)" in out
    line = next(ln for ln in out.splitlines() if "recall@10=" in ln)
    assert float(line.split("recall@10=")[1].split()[0]) >= 0.8
    assert "hops/query=" in line and "meanL=" in line
    tserve.main(TINY + ["--distributed", "4"])
    line = capsys.readouterr().out.splitlines()[-1]
    assert "recall@10=" in line and "hops/query=" not in line


def test_launcher_distributed_per_shard_calibration(capsys):
    tserve.main(TINY + ["--distributed", "4", "--adaptive", "--calibrate",
                        "--per-shard", "--calib-sample", "16",
                        "--recall-target", "0.9"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "per-shard laws" in ln)
    assert line.count(",") >= 6 and "hop_factor=" in line
    assert "recall@10=" in out


@pytest.mark.parametrize("argv", [
    ["--distributed", "4", "--adaptive", "--serve"],
    ["--adaptive", "--calibrate", "--per-shard"],
    ["--distributed", "4", "--per-shard"],
    ["--distributed", "4", "--adaptive", "--calibrate"],
    ["--distributed", "4", "--filter-frac", "0.5"],
    ["--distributed", "4", "--index", "i.npz"],
    ["--distributed", "4", "--online"],
    ["--distributed", "4", "--vamana"],
    ["--distributed", "4", "--disk", "d.blocks"],
    ["--distributed", "4", "--backend", "exact"],
])
def test_launcher_rejects_distributed_misuse(argv):
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu"] + argv)


# ------------------------------------- walk counters read at collection


def _stuck(monkeypatch):
    """Every walk given a counter reports one lane that could still move."""
    real = ops.beam_walk

    def stuck(*args, active_count=None, **kw):
        out = real(*args, active_count=active_count, **kw)
        if active_count is not None:
            active_count += 1
        return out

    monkeypatch.setattr(ops, "beam_walk", stuck)


def _fixed_engines(device="cpu"):
    """Fixed-beam engines over an exact and a tiered backend, and a
    monolithic distributed one, on a small float world."""
    from repro_torch.index import build_tiered_index

    x, q = _float_world(400, 8, 16, seed=6)
    g = tbuild.build_mcgi(torch.from_numpy(x), tbuild.BuildConfig(
        degree=8, beam_width=16, iters=1, batch=64, max_hops=32),
        device=device)
    idx = build_tiered_index(torch.from_numpy(x), g, m_pq=4, device=device)
    mesh = make_mesh((4,), ("data",), device)
    arrays, _ = tss.build_sharded_arrays(x, mesh, build_cfg=tbuild
                                         .BuildConfig(degree=8,
                                                      beam_width=16, iters=1,
                                                      batch=64, max_hops=32),
                                         m_pq=4)
    backs = {"exact": tserving.ExactBackend(x, g.adj, g.entry, device=device),
             "tiered": tserving.TieredBackend(idx, device=device),
             "distributed": tserving.DistributedBackend(
                 mesh, arrays, beam_width=16, max_hops=32, k=5,
                 query_chunk=8)}
    return ({k: tserving.SearchEngine(b, None, k=5, beam_width=16,
                                      max_hops=32) for k, b in backs.items()},
            q[:8])


def test_fixed_beam_walk_counter_moves_to_collection(monkeypatch):
    """A fixed-beam (or monolithic) ``begin`` leaves its walk's counter
    unread; collecting the flight reads it and raises as ``run_batch``
    does."""
    engines, q = _fixed_engines()
    want = {k: e.search(q) for k, e in engines.items()}
    _stuck(monkeypatch)
    for name, eng in engines.items():
        f = eng.begin(q)
        with pytest.raises(RuntimeError, match="could still move"):
            eng.finish_from(f)
        with pytest.raises(RuntimeError, match="could still move"):
            eng.search(q)
    monkeypatch.undo()
    for name, eng in engines.items():
        got = eng.finish_from(eng.begin(q))
        np.testing.assert_array_equal(got.ids, want[name].ids)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fixed_and_distributed_begin_do_not_wait_for_the_card(cuda):
    """``begin`` of fixed-beam exact and tiered engines and of staged and
    monolithic distributed engines queues its walks behind a busy stream
    without a host sync (sync debug mode "error"); the results equal a
    direct search."""
    engines, q = _fixed_engines("cuda")
    back = engines["distributed"].backend
    budget = tsearch.AdaptiveBeamBudget(l_min=4, l_max=16, center=6.0)
    engines["staged"] = tserving.SearchEngine(
        tserving.DistributedBackend(back.mesh, back.arrays, beam_width=16,
                                    max_hops=32, k=5, query_chunk=8,
                                    beam_budget=budget, budget_buckets=4),
        budget, k=5)
    for name, eng in engines.items():
        want = eng.search(q)
        with torch.cuda.stream(eng._stream):
            torch.cuda._sleep(100_000_000)            # the stream is busy
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            f = eng.begin(q)
            t_begin = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not f.event.query(), name              # queued, not run
        got = eng.finish_from(f)
        assert t_begin < 0.04, (name, t_begin)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.d2, want.d2)


def test_distributed_stream_under_thread_switches(ref):
    """Two threads stream the same staged distributed engine at once under
    a 1 us switch interval; every result equals the one-thread answer."""
    a = _port_arrays(ref)
    eng = tserving.SearchEngine(_backend(a), _budget(), k=K)
    batches = _stream_batches(ref["q"])
    want = [r.ids for r in eng.search_batches(batches)]
    errors: list = []

    def worker():
        try:
            for _ in range(3):
                got = [r.ids for r in eng.search_batches(batches)]
                if not all((g == w).all() for g, w in zip(got, want)):
                    errors.append("results moved")
        except Exception as e:      # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]


def _card_world(dev, mesh):
    """A small float world built on ``mesh`` from numpy seeds: (arrays,
    queries on the mesh's device, the staged budget)."""
    x, q = _float_world(4096, 16, 64, seed=8)
    arrays, _ = tss.build_sharded_arrays(
        x, mesh, build_cfg=tbuild.BuildConfig(degree=8, beam_width=16,
                                              iters=1, batch=256,
                                              max_hops=32), m_pq=4)
    budget = tsearch.AdaptiveBeamBudget(l_min=4, l_max=16, lam=0.35,
                                        center=6.0)
    return arrays, torch.from_numpy(q).to(dev), budget


@pytest.mark.gpu
def test_shard_streams_equal_each_shard_alone_on_card(cuda):
    """One card, a stream a shard: each shard's top-k (the merge's inputs)
    equals its walk run alone on the card's default stream, and a staged
    engine's stream does not move under a short switch interval."""
    mesh = make_mesh(*MESH, devices="cuda:0")
    assert len(set(mesh.streams)) == S
    arrays, q, budget = _card_world(cuda, mesh)
    kw = dict(beam_width=16, max_hops=32, k=5, query_chunk=16)
    got, real = {}, tss._hedged_merge

    def keep(d2, ids, *args, **kw_):
        got["d2"], got["ids"] = d2.cpu(), ids.cpu()
        return real(d2, ids, *args, **kw_)

    a = tss.place_arrays(mesh, arrays)
    tss._hedged_merge = keep
    try:
        tss.distributed_search(mesh, a, q, beam_budget=budget,
                               budget_buckets=4, **kw)
    finally:
        tss._hedged_merge = real
    ctxs = tss._shard_ctxs(a["centroids"], q, True)
    for s in range(S):
        d2, ids = tss._local_search(
            a["adj"].parts[s], a["codes"].parts[s], a["vectors"].parts[s],
            ctxs, q, a["entries"].parts[s][0], use_pq=True,
            beam_budget=budget,
            bucket_ceilings=tss._bucket_ceilings(budget, 4), **kw)
        assert torch.equal(d2.cpu(), got["d2"][s]), s
        assert torch.equal(ids.cpu(), got["ids"][s]), s
    eng = tserving.SearchEngine(tserving.DistributedBackend(
        mesh, arrays, beam_budget=budget, budget_buckets=4, **kw), budget,
        k=5)
    batches = [q[:16].cpu().numpy(), q[16:48].cpu().numpy(),
               q[48:].cpu().numpy()]
    want = [r.ids for r in eng.search_batches(batches)]
    errors: list = []

    def worker():
        try:
            for _ in range(3):
                res = [r.ids for r in eng.search_batches(batches)]
                if not all((g == w).all() for g, w in zip(res, want)):
                    errors.append("results moved")
        except Exception as e:      # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    return torch.cuda.device_count()


@pytest.mark.gpu
def test_mesh_over_every_card_equals_one_card(two_cards):
    """The (2, 4) mesh over every card: each shard's rows on its own card,
    and every search, probe state and engine result bit-identical to the
    same mesh on one card."""
    one = make_mesh(*MESH, devices="cuda:0")
    every = make_mesh(*MESH)
    assert len(every.devices) == min(two_cards, S)
    q_dev = torch.device("cuda", 0)
    arrays, q, budget = _card_world(q_dev, one)
    placed = tss.place_arrays(every, arrays)
    for s, d in enumerate(every.shard_devices):
        assert placed["vectors"].parts[s].device == d
    kw = dict(beam_width=16, max_hops=32, k=5, query_chunk=16)
    laws = (LAWS[0], LAWS[1])
    for extra in (dict(), dict(beam_budget=budget, budget_buckets=4),
                  dict(beam_budget=budget, budget_buckets=4, merge="flat",
                       shard_laws=laws)):
        want = tss.distributed_search(one, arrays, q, **kw, **extra)
        got = tss.distributed_search(every, placed, q, **kw, **extra)
        for g, w in zip(got, want):
            assert g.device == q_dev and torch.equal(g, w)
    probe = {m: tss.make_distributed_probe(
        m, budget_cfg=budget, max_hops=32, query_chunk=16, budget_buckets=4)
        for m in (one, every)}
    a1 = tss.place_arrays(one, arrays)
    st1 = probe[one](a1["adj"], a1["codes"], a1["vectors"],
                     a1["centroids"], q, a1["entries"])
    st2 = probe[every](placed["adj"], placed["codes"], placed["vectors"],
                       placed["centroids"], q, placed["entries"])
    for leaf1, leaf2 in zip(st1[0][:6], st2[0][:6]):
        assert [p.device for p in leaf2.parts] == list(every.shard_devices)
        assert torch.equal(leaf1.cpu(), leaf2.cpu())
    for e1, e2 in zip(st1[1:], st2[1:]):
        assert torch.equal(e1, e2)
    qs = q.cpu().numpy()
    for eng_budget in (budget, None):
        res = [tserving.SearchEngine(tserving.DistributedBackend(
            m, arrays, beam_budget=budget, budget_buckets=4, **kw),
            eng_budget, k=5).search(qs) for m in (one, every)]
        np.testing.assert_array_equal(res[0].ids, res[1].ids)
        np.testing.assert_array_equal(res[0].d2, res[1].d2)


@pytest.mark.gpu
def test_kernels_launch_on_their_tensors_card(two_cards):
    """``ops.beam_walk`` and ``ops.topk`` on the last card, launched while
    the first is current, equal the same calls on the first card."""
    from repro_torch.core import build as cbuild

    first, last = torch.device("cuda", 0), torch.device("cuda", two_cards - 1)
    g = torch.Generator(device="cpu").manual_seed(3)
    n, nq, width, r, d = 5000, 64, 32, 16, 16
    adj = cbuild.random_graph(n, r, g)
    table = torch.randint(-8, 9, (n, d), generator=g).float()
    ctxs = torch.randint(-8, 9, (nq, d), generator=g).float()
    entry = torch.randint(0, n, (nq,), generator=g, dtype=torch.int32)
    dist = torch.randint(0, 50, (nq, 4000), generator=g).float()

    def walk(dev):
        ev = tsearch._exact_eval(table.to(dev))
        st = tsearch._init_state(ctxs.to(dev), entry.to(dev), ev, n, width,
                                 None)
        out = ops.beam_walk(st, ctxs.to(dev), adj.to(dev), table.to(dev),
                            width, 20, kind="exact", max_hops=ops.MAX_HOPS)
        return [t.cpu() for t in out] + [
            t.cpu() for t in ops.topk(dist.to(dev), 17)]

    assert torch.cuda.current_device() == 0
    for a, b in zip(walk(first), walk(last)):
        assert torch.equal(a, b)
    assert torch.cuda.current_device() == 0


if __name__ == "__main__":
    if sys.argv[1:2] != ["ref"] or len(sys.argv) != 3:
        raise SystemExit("usage: test_torch_distributed.py ref OUT.npz")
    _reference(sys.argv[2])
