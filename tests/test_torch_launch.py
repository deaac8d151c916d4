"""The port's dry-run modules (``repro_torch.launch``: ``mesh``,
``shardings``, ``cells``, ``hlo_analysis``, ``dryrun``) and the kernels'
meta branch against the reference.

The reference's cells need its (16, 16) production mesh, 256 XLA devices,
which a process that has already imported JAX cannot get.  So this file
runs itself as a subprocess (``python tests/test_torch_launch.py ref
OUT.json``) that sets ``XLA_FLAGS`` before it imports JAX, builds every
reference cell and writes its argument leaves, the family sharding specs
and ``--list``'s lines to one JSON file; its top level imports neither JAX
nor ``repro``.

* Every one of the 45 cells at its full config: each argument leaf has the
  reference's global shape and dtype (an LM tree through the reference's
  stacked names), the donated arguments are the same, and the argument
  bytes are equal exactly.
* The sharding record (specs and divisibility at 16 x 16) equals the
  reference's for one full config of each family.
* Each kernel's meta output has the plain version's shapes and dtypes and
  counts no launch; FLOPs of a smoke prefill and a smoke DLRM serve equal
  their closed forms; the peak counter is exact on a hand-built sequence.
"""
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
# One full config of each family whose sharding record is compared (the GAT
# at its full_graph_sm regime).
SPEC_ARCHS = ("qwen2-7b", "deepseek-v2-lite-16b", "dlrm-mlperf", "gat-cora")


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _spec_json(spec):
    return json.loads(json.dumps(spec))


# ------------------------------------------------- the reference's side


def _reference(out_path: str) -> None:
    """Build every reference cell on the 16 x 16 mesh of 256 virtual
    devices and write what this file compares against."""
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=256 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax

    from repro.configs import base as cfg_base
    from repro.launch import cells, shardings
    from repro.launch.mesh import make_production_mesh
    from repro.models import gnn, recsys, transformer

    def name(path) -> str:
        parts = []
        for p in path:
            for attr in ("key", "idx", "name"):
                if hasattr(p, attr):
                    parts.append(str(getattr(p, attr)))
                    break
        return "/".join(parts)

    mesh = make_production_mesh()
    out = {"cells": cells.all_cells(), "args": {}, "specs": {}}
    for arch, shape in out["cells"]:
        cell = cells.build_cell(arch, shape, mesh)
        leaves = jax.tree_util.tree_flatten_with_path(cell.arg_specs)[0]
        out["args"][f"{arch}|{shape}"] = {
            "donate": list(cell.donate),
            "leaves": {name(p): [list(x.shape), str(x.dtype)]
                       for p, x in leaves}}
    for arch in SPEC_ARCHS:
        spec = cfg_base.get(arch)
        key = jax.random.PRNGKey(0)
        if spec.family == "lm":
            shapes = jax.eval_shape(
                lambda k: transformer.init_lm(spec.config, k), key)
        elif spec.family == "recsys":
            shapes = jax.eval_shape(
                lambda k: recsys.dlrm_init(k, spec.config), key)
        else:
            meta = spec.cell("full_graph_sm").meta
            gcfg = spec.config.for_regime(meta["d_feat"], meta["n_classes"])
            shapes = jax.eval_shape(lambda k: gnn.gat_init(k, gcfg), key)
        specs = shardings.param_specs(spec.family, shapes)
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        out["specs"][arch] = {
            "params": {name(p): _spec_json(tuple(s)) for p, s in flat[0]},
            "div": sorted(shardings.check_divisibility(shapes, specs, mesh))}
    from repro.launch import dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        argv, sys.argv = sys.argv, ["dryrun", "--list"]
        try:
            dryrun.main()
        finally:
            sys.argv = argv
    out["list"] = buf.getvalue().splitlines()
    pathlib.Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's records, built once in a subprocess with 256
    virtual XLA devices (bounded wait)."""
    path = tmp_path_factory.mktemp("launch") / "ref.json"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, __file__, "ref", str(path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(path.read_text())


# ------------------------------------------------------ the port's side

if __name__ != "__main__":
    from repro_torch.configs import base as tbase
    from repro_torch.kernels import ops
    from repro_torch.launch import cells as tcells
    from repro_torch.launch import dryrun as tdryrun
    from repro_torch.launch import hlo_analysis as tha
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import shardings as tshard

    MESH = tmesh.make_production_mesh(device="meta")
    CELLS = tcells.all_cells()


def test_all_cells_equal_the_reference(ref):
    """In order, also in a process whose first import registered the MCGI
    datasets and qwen2-7b ahead of the other configs."""
    assert [list(c) for c in CELLS] == ref["cells"]
    assert len(CELLS) == 45
    code = ("import json, repro_torch.configs.mcgi_datasets, "
            "repro_torch.configs.qwen2_7b\n"
            "from repro_torch.launch import cells\n"
            "print(json.dumps(cells.all_cells()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout) == ref["cells"]


@pytest.mark.parametrize("arch,shape", CELLS if __name__ != "__main__"
                         else [], ids=lambda v: str(v))
def test_cell_arguments_match_the_reference(ref, arch, shape):
    """Every argument leaf at the full config: the reference's name, global
    shape and dtype; the donated arguments; the argument bytes exactly."""
    want = ref["args"][f"{arch}|{shape}"]
    cell = tcells.build_cell(arch, shape, MESH)
    got = {name: [list(t.shape), _dtype(t.dtype)]
           for name, t in tcells.arg_leaves(cell)}
    assert got == want["leaves"]
    assert list(cell.donate) == want["donate"]
    want_bytes = sum(
        torch.empty(s, dtype=getattr(torch, d), device="meta").numel()
        * getattr(torch, d).itemsize for s, d in want["leaves"].values())
    assert tcells.arg_bytes(cell) == want_bytes
    assert all(t.device.type in ("meta", "cpu")
               for _, t in tcells.arg_leaves(cell))


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_sharding_record_matches_the_reference(ref, arch):
    spec = tbase.get(arch)
    if spec.family == "lm":
        params = tcells.tfm.init_lm(spec.config, None, device="meta",
                                    dtype=torch.float32)
    elif spec.family == "recsys":
        params = tcells.recsys_mod.dlrm_init(None, spec.config, device="meta")
    else:
        meta = spec.cell("full_graph_sm").meta
        gcfg = spec.config.for_regime(meta["d_feat"], meta["n_classes"])
        params = tcells.gnn_mod.gat_init(None, gcfg, device="meta")
    specs = tshard.param_specs(spec.family, params)
    assert _spec_json(specs) == ref["specs"][arch]["params"]
    div = tshard.check_divisibility(tshard.reference_shapes(params), specs,
                                    MESH.shape)
    assert sorted(div) == ref["specs"][arch]["div"]
    state = tshard.train_state_specs(
        spec.family, tcells.ts_mod.init_train_state(params))
    assert state["params"] == specs and state["opt"]["m"] == specs
    assert state["opt"]["step"] == () and state["error_feedback"] is None


def test_production_mesh():
    assert MESH.shape == {"data": 16, "model": 16}
    assert tmesh.n_devices(MESH) == 256 and MESH.device.type == "meta"
    assert tmesh.dp_axes(MESH) == ("data",)
    assert tmesh.all_axes(MESH) == ("data", "model")
    host = tmesh.make_host_mesh(device="cpu")
    assert host.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        tmesh.make_production_mesh(multi_pod=True, device="meta")
    with pytest.raises(ValueError):
        import repro_torch

        repro_torch.resolve_device("meta")     # still refused elsewhere


# ------------------------------------------------ the kernels on meta


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _same_shapes(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == [
        (tuple(w.shape), w.dtype, "meta") for w in want]


def _walk_problem():
    from repro_torch.core import search

    g = torch.Generator().manual_seed(0)
    n, d, q, r, width = 200, 8, 6, 4, 8
    adj = torch.randint(0, n, (n, r), generator=g, dtype=torch.int32)
    table = torch.randint(-4, 5, (n, d), generator=g).float()
    ctxs = torch.randint(-4, 5, (q, d), generator=g).float()
    state = search._init_state(ctxs, 5, search._exact_eval(table), n, width)
    return (tuple(state), ctxs, adj, table,
            torch.full((q,), width, dtype=torch.int32),
            torch.full((q,), 4, dtype=torch.int32))


def test_kernel_meta_outputs_match_the_cpu():
    """Each wrapper on meta tensors: the CPU output's shapes and dtypes, no
    launch counted, one shape call counted."""
    g = torch.Generator().manual_seed(1)
    q, x = torch.rand(5, 8, generator=g), torch.rand(40, 8, generator=g)
    d = torch.rand(5, 40, generator=g)
    luts = torch.rand(3, 4, 16, generator=g)
    codes = torch.randint(0, 16, (50, 4), generator=g).byte()
    qa = torch.rand(2, 4, 8, generator=g)
    kv = torch.rand(2, 9, 2, 8, generator=g).bfloat16()
    lens = torch.tensor([3, 9], dtype=torch.int32)
    state, ctxs, adj, table, b, h = _walk_problem()
    cases = [
        (ops.bulk_l2, (q, x), "l2_distance"),
        (ops.topk, (d, 7), "topk"),
        (ops.lid_estimate, (torch.sort(d, 1).values[:, 1:9],), "lid_estimate"),
        (ops.pq_bulk_scan, (luts, codes), "pq_scan"),
        (ops.decode_attention, (qa, kv, kv, lens), "decode_attention"),
    ]
    before = ops.launch_counts()
    ops.reset_shape_calls()
    with ops.shapes_only():
        for fn, args, name in cases:
            margs = [_meta(a) if isinstance(a, torch.Tensor) else a
                     for a in args]
            _same_shapes(fn(*margs), fn(*args))
        mstate = tuple(_meta(t) for t in state)
        walked = ops.beam_walk(mstate, _meta(ctxs), _meta(adj), _meta(table),
                               _meta(b), _meta(h), kind="exact", max_hops=3)
        assert walked is mstate
    assert ops.launch_counts() == before
    assert ops.shape_calls() == {name: 1 for _, _, name in cases} | {
        "beam_step.exact": 1}
    # Outside the mode a meta tensor raises, as any other device does.
    with pytest.raises(ValueError):
        ops.bulk_l2(_meta(q), _meta(x))


def test_kernel_meta_checks_raise_where_the_kernels_do():
    """The meta branch runs the kernel's argument checks: each call below
    raises on the CPU's plain path or the card's checks alike."""
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,  # noqa: E731
                                                 device="meta")
    state, ctxs, adj, table, b, h = _walk_problem()
    with ops.shapes_only():
        with pytest.raises(ValueError):
            ops.bulk_l2(m(5, 8), m(40, 9))               # D mismatch
        with pytest.raises(ValueError):
            ops.topk(m(5, 40), 41)                      # k > N
        with pytest.raises(ValueError):
            ops.topk(m(5, 40), 0)
        with pytest.raises(ValueError):
            ops.lid_estimate(m(5, 0))
        with pytest.raises(ValueError):
            ops.pq_bulk_scan(m(3, 4, 16), m(50, 5, dt=torch.uint8))
        with pytest.raises(ValueError):
            ops.decode_attention(m(2, 3, 8), m(2, 9, 2, 8, dt=torch.bfloat16),
                                 m(2, 9, 2, 8, dt=torch.bfloat16),
                                 m(2, dt=torch.int32))  # Hq % Hkv
        with pytest.raises(ValueError):
            ops.beam_walk(tuple(_meta(t) for t in state), _meta(ctxs),
                          _meta(adj), _meta(table), _meta(b), _meta(h),
                          kind="nope", max_hops=1)
    cpu = [
        lambda: ops.bulk_l2(torch.rand(5, 8), torch.rand(40, 9)),
        lambda: ops.topk(torch.rand(5, 40), 41),
        lambda: ops.topk(torch.rand(5, 40), 0),
        lambda: ops.beam_walk(state, ctxs, adj, table, b, h, kind="nope",
                              max_hops=1),
    ]
    for call in cpu:
        with pytest.raises((ValueError, RuntimeError)):
            call()


# ---------------------------------------------------- the cost counters


def test_peak_counter_is_exact():
    """Live bytes through a hand-built run of allocations and frees."""
    arg = torch.empty(10, device="meta")                 # 40 B alive before
    with tha.CostMode(live=[arg]) as mode:
        a = torch.empty(100, device="meta")              # +400 -> 440
        b = torch.empty(50, dtype=torch.float64, device="meta")  # +400 -> 840
        del a                                            # -> 440
        c = torch.empty(300, dtype=torch.int32, device="meta")   # -> 1640
        v = c.view(10, 30)                               # a view: nothing
        h = torch.empty(1000)                            # the host: nothing
        del b, c, v
        d = torch.empty(2, dtype=torch.bfloat16, device="meta")  # 44
    assert mode.start_bytes == 40
    assert mode.peak_bytes == 1640
    assert mode.live_bytes == 44
    assert mode.flops == 0 and h.numel() == 1000 and d.numel() == 2


def test_flops_and_bytes_of_one_product():
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 4, dtype=torch.float32, device="meta")
    with tha.CostMode() as mode:
        a @ b
        (a.bfloat16() @ b.bfloat16()).t()
    assert mode.flops_by_dtype == {"float32": 2 * 8 * 16 * 4,
                                   "bfloat16": 2 * 8 * 16 * 4}
    # mm reads both and writes one; each cast reads one and writes one.
    f32 = (8 * 16 + 16 * 4 + 8 * 4) * 4
    casts = (8 * 16 + 16 * 4) * (4 + 2)
    assert mode.bytes_accessed == f32 + casts + (8 * 16 + 16 * 4 + 8 * 4) * 2
    terms = tha.roofline_terms(flops_by_dtype=mode.flops_by_dtype,
                               bytes_accessed=mode.bytes_accessed)
    assert terms["compute_s"] == pytest.approx(
        1024 / 67e12 + 1024 / 989e12, rel=1e-12)
    assert terms["memory_s"] == pytest.approx(mode.bytes_accessed / 3.35e12)
    assert terms["dominant"] == "memory_s"


def _small(cell_kind, arch, meta):
    spec = tbase.get(arch)
    shape = next(c for c in spec.shapes if c.kind == cell_kind)
    return spec, dataclasses.replace(shape, meta=meta)


def test_lm_prefill_flops_equal_the_closed_form():
    """The smoke qwen2's prefill at (2, 64): the projections, every block
    of the blockwise attention (masked or not), the FFN and the last
    position's head, exactly."""
    spec, shape = _small(tbase.PREFILL, "qwen2-7b", {"batch": 2, "seq": 64})
    cell = tcells._lm_cell(spec, shape, MESH, smoke=True)
    cfg = spec.smoke_config
    b, s, d, f, v = 2, 64, cfg.d_model, cfg.d_ff, cfg.vocab
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    layer = (2 * b * s * d * (hq + 2 * hkv) * dh      # q, k, v
             + 2 * 2 * b * hq * s * s * dh            # QK^T and PV, all blocks
             + 2 * b * s * hq * dh * d                # o
             + 3 * 2 * b * s * d * f)                 # SwiGLU
    want = cfg.n_layers * layer + 2 * b * d * v       # last position's head
    got = tdryrun.measure(cell)
    assert got["cost"]["flops_per_device"] == want
    assert got["cost"]["flops_by_dtype"] == {"float32": want}
    assert got["kernels"] == {}


def test_dlrm_serve_flops_equal_the_closed_form():
    spec, shape = _small(tbase.SERVE, "dlrm-mlperf", {"batch": 24})
    cell = tcells._recsys_cell(spec, shape, MESH, smoke=True)
    cfg = spec.smoke_config
    b, e, fields = 24, cfg.embed_dim, cfg.n_sparse + 1
    mlp = lambda sizes: sum(2 * b * i * o  # noqa: E731
                            for i, o in zip(sizes, sizes[1:]))
    want = (mlp((cfg.n_dense,) + cfg.bot_mlp)
            + 2 * b * fields * fields * e              # the pairwise dots
            + mlp((cfg.n_interact + cfg.bot_mlp[-1],) + cfg.top_mlp))
    got = tdryrun.measure(cell)
    assert got["cost"]["flops_per_device"] == want
    assert got["memory"]["output_bytes"] == b * 4


def test_lm_decode_reaches_decode_attention_on_meta():
    """A smoke decode cell runs through the kernel's meta branch: one shape
    call a layer, the cache donated (aliased), no launch."""
    spec, shape = _small(tbase.DECODE, "qwen2-7b", {"batch": 2, "seq": 32})
    cell = tcells._lm_cell(spec, shape, MESH, smoke=True)
    before = ops.launch_counts()
    got = tdryrun.measure(cell)
    assert got["kernels"] == {"decode_attention":
                              spec.smoke_config.n_layers}
    assert ops.launch_counts() == before
    cache = sum(t.numel() * t.element_size()
                for t in cell.arg_specs[1].values())
    assert got["memory"]["alias_bytes"] == cache


@pytest.mark.parametrize("cards", [2, 4])
def test_mcgi_serve_cell_priced_per_card(tmp_path, cards):
    """``--cards N``: the 256 shards in contiguous blocks over N cards; a
    card holds its shards' rows, entries and laws (a 1/N share), the
    replicated codebook and queries whole, and as many walks as before
    (32 streams' worth, at most)."""
    mesh = tmesh.make_production_mesh(device="meta", cards=cards)
    assert tmesh.n_devices(mesh) == cards and mesh.n_shards == 256
    assert mesh.placement == tuple(s * cards // 256 for s in range(256))
    one = tdryrun.run_one("mcgi-sift1b", "serve", tmp_path)
    many = tdryrun.run_one("mcgi-sift1b", "serve", tmp_path, cards=cards)
    assert (tmp_path / f"mcgi-sift1b__serve__card{cards}.json").exists()
    assert one["n_chips"] == 1 and many["n_chips"] == cards
    e1 = one["memory"]["argument_bytes_each"]
    ec = many["memory"]["argument_bytes_each"]
    for i in (0, 1, 2, 5, 6, 7, 8):             # laid over the shards
        assert ec[i] * cards == e1[i]
    for i in (3, 4):                            # centroids, queries
        assert ec[i] == e1[i]
    assert many["memory"]["temp_bytes"] == one["memory"]["temp_bytes"]
    assert many["memory"]["peak_per_device_bytes"] == (
        sum(ec) + many["memory"]["temp_bytes"]
        + many["memory"]["output_bytes"])
    with pytest.raises(ValueError, match="--cards"):
        tdryrun.run_one("qwen2-7b", "decode_32k", tmp_path, smoke=True,
                        cards=cards)


def test_mcgi_index_bytes_equal_a_built_backend():
    """The smoke T2I cell's index at the host mesh (2 x 4) against a
    DistributedBackend built on the CPU over the smoke index."""
    import numpy as np

    from repro_torch.core.build import BuildConfig
    from repro_torch.distributed import sharded_search as tss
    from repro_torch.serving import DistributedBackend

    spec = tbase.get("mcgi-t2i1b")
    cfg = spec.smoke_config
    mesh_meta = tmesh.make_host_mesh(device="meta")
    cell = tcells.build_cell("mcgi-t2i1b", "serve", mesh_meta, smoke=True)
    names = ("adj", "codes", "vectors", "centroids", "queries", "shard_ok",
             "entries", "shard_lam", "shard_l_min")
    got = dict(zip(names, cell.arg_specs))
    mesh = tmesh.make_host_mesh(device="cpu")
    x = np.random.default_rng(0).standard_normal((cfg.n, cfg.d)).astype(
        np.float32)
    arrays, _ = tss.build_sharded_arrays(
        x, mesh, build_cfg=BuildConfig(degree=cfg.degree, beam_width=16,
                                       iters=1, batch=256, max_hops=16),
        m_pq=cfg.m_pq, pq_iters=1)
    backend = DistributedBackend(
        mesh, arrays, beam_width=cfg.l_search, max_hops=cfg.max_hops, k=10,
        shard_laws=cfg.shard_budget_laws(mesh.n_shards))
    held = dict(backend.arrays)
    held["shard_lam"], held["shard_l_min"] = backend.shard_laws
    for name, t in held.items():
        assert (tuple(got[name].shape), got[name].dtype) == (
            tuple(t.shape), t.dtype), name
    nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                            for t in ts)
    assert nbytes(got[n] for n in held) == nbytes(held.values())


def test_run_one_writes_a_record_per_family(tmp_path):
    """One smoke cell of each family: the record's keys."""
    for arch, shape in (("qwen2-7b", "decode_32k"),
                        ("dlrm-mlperf", "serve_p99"),
                        ("gat-cora", "full_graph_sm"),
                        ("mcgi-sift1m", "serve")):
        rec = tdryrun.run_one(arch, shape, tmp_path, smoke=True)
        path = tmp_path / f"{arch}__{shape}-smoke__card1.json"
        assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
        assert {"arch", "shape", "mesh", "n_chips", "note", "timings_s",
                "memory", "cost", "roofline", "torch_version"} <= set(rec)
        assert rec["n_chips"] == 1 and rec["mesh"] == [16, 16]
        assert set(rec["memory"]) == {
            "argument_bytes", "argument_bytes_each", "output_bytes",
            "temp_bytes", "alias_bytes", "peak_per_device_bytes"}
        assert sum(rec["memory"]["argument_bytes_each"]) == \
            rec["memory"]["argument_bytes"]
        assert {"flops_per_device", "flops_by_dtype",
                "bytes_accessed_per_device", "accounting"} <= set(rec["cost"])
        assert rec["cost"]["accounting"] == (
            "shapes" if arch.startswith("mcgi") else "traced")
        assert rec["memory"]["peak_per_device_bytes"] >= \
            rec["memory"]["argument_bytes"] - 4
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
    rec = tdryrun.run_one("gat-cora", "molecule", tmp_path)   # full config
    rows = tdryrun.table(tmp_path)
    assert len(rows) == 2 + len(CELLS)
    row = rows[2 + CELLS.index(("gat-cora", "molecule"))]
    assert row.startswith("| gat-cora / molecule | ") and "| yes |" in row
    assert sum("no record" in r for r in rows) == len(CELLS) - 1


def test_list_prints_the_reference_lines(ref):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tdryrun.main(["--list"]) == 0
    assert buf.getvalue().splitlines() == ref["list"]


def test_cells_module_keeps_the_reference_optimizer_settings():
    assert tcells.RECSYS_OPT == {"lr": 1e-3, "weight_decay": 0.0}
    assert tcells.GAT_OPT == {"lr": 5e-3, "weight_decay": 5e-4}
    assert tcells.lm_schedule("minicpm-2b") == "wsd"
    assert tcells.lm_schedule("qwen2-7b") == "cosine"
    from repro_torch.launch import train as ttrain

    for arch in ("minicpm-2b", "qwen2-7b"):
        assert ttrain.train_config(arch, 3e-4, 100).schedule == \
            tcells.lm_schedule(arch)


if __name__ == "__main__":
    if sys.argv[1:2] != ["ref"] or len(sys.argv) != 3:
        raise SystemExit("usage: test_torch_launch.py ref OUT.json")
    _reference(sys.argv[2])
