"""The port's expert-parallel MoE schedule (``models/moe.py``:
``moe_apply_expert_parallel``, ``_expert_parallel_ok``, ``_axis_size``)
and the ``mesh`` argument of ``lm_loss`` / ``prefill`` against the
reference's ``shard_map`` schedule under a ``ShardCtx``.

The reference's schedule needs 8 XLA devices, which a process that has
already imported JAX cannot get.  So this file runs itself as a subprocess
(``python tests/test_torch_moe_ep.py ref OUT.npz``) that sets
``XLA_FLAGS`` before it imports JAX, runs every reference case on the
meshes (2, 4) and (4, 2) (and the ("pod", "data", "model") mesh (2, 2, 2)
for the layer) and writes each output to one ``.npz``; its top level
imports neither JAX nor ``repro``, so the ``gpu`` tests run on the card
without JAX.  Both MoE smoke configs (qwen3-moe, deepseek-v2-lite with its
shared experts) are used.

* Integer-valued tokens and router weights (exact logits): each rank's
  expert ids, ``dest`` and ``keep`` are bit-identical to the reference's
  (read inside its ``shard_map`` by a debug callback on the rank's axis
  indices) at capacity factors 1.0 and 0.5; the output is within 1e-5.
* Float data at capacity factor 8.0: output and aux within 1e-5 of the
  reference's schedule and of ``moe_apply(n_groups=1)``
  (``tests/test_distributed.py``'s bounds); autograd's gradients of x, the
  router, the experts and the shared experts within relative L2 1e-5 of
  ``jax.grad``'s.
* The slice: ``lm_loss`` (loss, ce, aux and every gradient) and
  ``prefill``'s logits on a mesh within 1e-4 relative of the reference's
  with ``ShardCtx(mesh, ("data",), "model")``, the reference's weights
  carried across by ``models/convert.py``; routing near-ties are counted
  and must be absent at the test's seed.
* ``_expert_parallel_ok``'s truth table equals the reference's, and
  ``moe_apply(mesh=...)`` on a mesh without the schedule takes the
  reference's group count (the data axes' product).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = ((2, 4), (4, 2))
POD = ((2, 2, 2), ("pod", "data", "model"))
ARCHS = {"qwen3-moe": "qwen3_moe_30b_a3b",
         "deepseek-v2-lite": "deepseek_v2_lite_16b"}
B, S = 4, 16                 # layer tokens: 8 a rank on either mesh
INT_CFS = (1.0, 0.5)
FLOAT_CF = 8.0               # ample: nothing dropped (the reference's scenario)
LM_B, LM_S = 4, 32
NEAR_TIE_RTOL = 1e-5
# _expert_parallel_ok's truth table: every (B, S, E) on every mesh.
TRUTH_MESHES = (((2, 4), AXES), ((4, 2), AXES), ((8, 1), AXES),
                ((1, 8), AXES), ((8,), ("data",)), POD)
TRUTH_SHAPES = [(b, s, e) for b in (2, 3, 4) for s in (6, 8, 16)
                for e in (4, 6, 8)]
# moe_apply on a mesh without the schedule (S = 6 does not split over 4;
# a "model" axis of 1): one group a data shard.
GROUP_CASES = (("2x4", (2, 4), AXES, 2), ("8x1", (8, 1), AXES, 8))
GROUP_SHAPE = (4, 6)


def _key(shape) -> str:
    return "x".join(map(str, shape))


def _moe_dims(mcfg) -> dict:
    return {f: getattr(mcfg, f) for f in ("d_model", "n_experts", "top_k",
                                          "d_expert", "n_shared", "d_shared")}


def _layer_data(dims: dict, integer: bool, seed: int, shape=(B, S)):
    """(params of float32 numpy arrays, x, the loss weights W): integer
    tokens in [-3, 3] and router in [-2, 2] when ``integer``."""
    rng = np.random.default_rng(seed)
    d, e, f = dims["d_model"], dims["n_experts"], dims["d_expert"]
    p = {"router": (rng.integers(-2, 3, (d, e)) if integer
                    else rng.standard_normal((d, e)) * 0.3),
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    if dims["n_shared"]:
        fs = (dims["d_shared"] or f) * dims["n_shared"]
        p["shared"] = {"w_gate": rng.standard_normal((d, fs)) * d ** -0.5,
                       "w_up": rng.standard_normal((d, fs)) * d ** -0.5,
                       "w_down": rng.standard_normal((fs, d)) * fs ** -0.5}
    p = _tree(p, lambda a: np.asarray(a, np.float32))
    x = (rng.integers(-3, 4, shape + (d,)) if integer
         else rng.standard_normal(shape + (d,)))
    w = rng.standard_normal(shape + (d,))
    return p, x.astype(np.float32), w.astype(np.float32)


def _lm_batch(vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (LM_B, LM_S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -100
    return {"tokens": toks[:, :-1], "labels": labels}


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _flat(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _unflat(ref: dict, prefix: str) -> dict:
    tree: dict = {}
    for name, a in ref.items():
        if not name.startswith(prefix + "/"):
            continue
        *path, leaf = name[len(prefix) + 1:].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


# ------------------------------------------------- the reference's side


def _reference(out_path: str) -> None:
    """Run every reference case on 8 virtual devices and write the
    outputs this file compares against."""
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    import importlib

    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.launch.mesh import dp_axes
    from repro.models import moe as jm
    from repro.models import transformer as jt
    from repro.models.layers import ShardCtx

    out: dict = {}
    mods = {a: importlib.import_module(f"repro.configs.{m}")
            for a, m in ARCHS.items()}

    def ctx_of(shape, axes):
        mesh = compat.make_mesh(shape, axes)
        return ShardCtx(mesh=mesh, dp=dp_axes(mesh), tp="model")

    ctxs = {_key(m): ctx_of(m, AXES) for m in MESHES}
    ctxs[_key(POD[0])] = ctx_of(*POD)
    seen: list = []
    real = jm._dispatch_group

    def spy(x_g, eid, cap, n):
        buf, dest, keep = real(x_g, eid, cap, n)
        jax.debug.callback(
            lambda i, j, e, d, k: seen.append(
                (int(i), int(j), np.asarray(e), np.asarray(d),
                 np.asarray(k))),
            jax.lax.axis_index("data"), jax.lax.axis_index("model"), eid,
            dest, keep)
        return buf, dest, keep

    for arch, mod in mods.items():
        dims = _moe_dims(mod.SMOKE_CONFIG.moe)
        # Integer data: each rank's routing and drop set, and the output.
        for m in MESHES:
            ctx = ctxs[_key(m)]
            for cf in INT_CFS:
                cfg = jm.MoeConfig(**dims, capacity_factor=cf)
                p, x, _ = _layer_data(dims, True, 1)
                seen.clear()
                jm._dispatch_group = spy
                try:
                    y, aux = jax.jit(lambda pp, xx: jm.moe_apply(
                        pp, cfg, xx, ctx))(p, x)
                    jax.effects_barrier()
                finally:
                    jm._dispatch_group = real
                tag = f"int/{arch}/{_key(m)}/{cf}"
                assert len(seen) == 8, len(seen)
                for i, j, e, d, k in seen:
                    out[f"{tag}/eid/{i}_{j}"] = e
                    out[f"{tag}/dest/{i}_{j}"] = d
                    out[f"{tag}/keep/{i}_{j}"] = k
                out[f"{tag}/out"], out[f"{tag}/aux"] = y, aux
        # Float data at an ample capacity: outputs and gradients.
        cfg = jm.MoeConfig(**dims, capacity_factor=FLOAT_CF)
        p, x, w = _layer_data(dims, False, 2)
        y1, aux1 = jax.jit(lambda pp, xx: jm.moe_apply(
            pp, cfg, xx, None, n_groups=1))(p, x)
        out[f"float/{arch}/out1"], out[f"float/{arch}/aux1"] = y1, aux1
        for name, ctx in ctxs.items():
            def loss(pp, xx, ctx=ctx):
                y, aux = jm.moe_apply(pp, cfg, xx, ctx)
                return jnp.sum(y * w) + aux, (y, aux)

            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
            tag = f"float/{arch}/{name}"
            out[f"{tag}/out"], out[f"{tag}/aux"] = y, aux
            _flat(gp, f"{tag}/grad", out)
            out[f"{tag}/grad/x"] = gx
        # The slice: lm_loss with its gradients, and prefill, on a mesh.
        tcfg = mod.SMOKE_CONFIG
        params = jax.jit(lambda k: jt.init_lm(tcfg, k))(
            jax.random.PRNGKey(3))
        _flat(params, f"lm/{arch}/param", out)
        batch = _lm_batch(tcfg.vocab, 4)
        for m in MESHES:
            ctx = ctxs[_key(m)]
            (loss, met), g = jax.jit(jax.value_and_grad(
                lambda pp, bb: jt.lm_loss(tcfg, pp, bb, ctx),
                has_aux=True))(params, batch)
            tag = f"lm/{arch}/{_key(m)}"
            out[f"{tag}/loss"] = loss
            out[f"{tag}/ce"], out[f"{tag}/aux"] = met["ce"], met["aux"]
            _flat(g, f"{tag}/grad", out)
            out[f"{tag}/logits"] = jax.jit(lambda pp, tt: jt.prefill(
                tcfg, pp, tt, ctx))(params, batch["tokens"])
        # A mesh where the schedule does not apply: the grouped path.
        cfg = jm.MoeConfig(**dims)
        p, x, _ = _layer_data(dims, True, 5, GROUP_SHAPE)
        for name, shape, axes, _ in GROUP_CASES:
            ctx = ctx_of(shape, axes)
            assert not jm._expert_parallel_ok(cfg, x, ctx)
            y, aux = jax.jit(lambda pp, xx: jm.moe_apply(
                pp, cfg, xx, ctx))(p, x)
            out[f"groups/{arch}/{name}/out"] = y
            out[f"groups/{arch}/{name}/aux"] = aux

    truth = [jm._expert_parallel_ok(
        jm.MoeConfig(d_model=1, n_experts=e, top_k=1, d_expert=1),
        np.empty((b, s, 1)), ctx_of(shape, axes))
        for shape, axes in TRUTH_MESHES for b, s, e in TRUTH_SHAPES]
    out["truth"] = np.asarray(truth)
    out["truth_no_ctx"] = np.asarray(jm._expert_parallel_ok(
        jm.MoeConfig(d_model=1, n_experts=8, top_k=1, d_expert=1),
        np.empty((4, 16, 1)), None))
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, made once in a subprocess with 8 virtual
    XLA devices (bounded wait)."""
    path = tmp_path_factory.mktemp("moe_ep") / "ref.npz"
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
T = torch.from_numpy
if __name__ != "__main__":
    import importlib

    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import lm_params_from_reference
    from repro_torch.training.optimizer import flatten

    TCFGS = {a: importlib.import_module(f"repro_torch.configs.{m}")
             .SMOKE_CONFIG for a, m in ARCHS.items()}


def _mesh(shape, axes=AXES, spread=False):
    """The port's mesh on the CPU: one device, or (``spread``) a list of
    one CPU entry a shard, whose ranks copy between "devices"."""
    n = int(np.prod(shape))
    return make_mesh(shape, axes, devices=["cpu"] * n if spread else "cpu")


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_layer(dims, cf, integer, seed, shape=(B, S)):
    cfg = tmoe.MoeConfig(**dims, capacity_factor=cf)
    p, x, w = _layer_data(dims, integer, seed, shape)
    return cfg, _tree(p, T), T(x), T(w)


def _port_ranks(monkeypatch):
    """Wrap the port's _dispatch_group: each call's (eid, dest, keep)."""
    seen = []
    real = tmoe._dispatch_group

    def spy(x_g, eid, cap, n_experts):
        buf, dest, keep = real(x_g, eid, cap, n_experts)
        seen.append((eid.numpy().copy(), dest.numpy().copy(),
                     keep.numpy().copy()))
        return buf, dest, keep
    monkeypatch.setattr(tmoe, "_dispatch_group", spy)
    return seen


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=_key)
@pytest.mark.parametrize("cf", INT_CFS)
@pytest.mark.parametrize("spread", [False, True], ids=["one", "listed"])
def test_ranks_route_and_drop_bit_identical_on_integer_data(
        ref, monkeypatch, arch, mesh_shape, cf, spread):
    dims = _moe_dims(TCFGS[arch].moe)
    cfg, p, x, _ = _port_layer(dims, cf, True, 1)
    mesh = _mesh(mesh_shape, spread=spread)
    assert tmoe._expert_parallel_ok(cfg, x, mesh)
    seen = _port_ranks(monkeypatch)
    y, aux = tmoe.moe_apply(p, cfg, x, mesh=mesh)
    tag = f"int/{arch}/{_key(mesh_shape)}/{cf}"
    ranks = tmoe._ranks(mesh)
    assert len(seen) == len(ranks) == 8
    dropped = 0
    for (i, j, _), (eid, dest, keep) in zip(ranks, seen):
        assert eid.dtype == np.int32 and dest.dtype == np.int32
        np.testing.assert_array_equal(eid, ref[f"{tag}/eid/{i}_{j}"])
        np.testing.assert_array_equal(dest, ref[f"{tag}/dest/{i}_{j}"])
        np.testing.assert_array_equal(keep, ref[f"{tag}/keep/{i}_{j}"])
        dropped += int((~keep).sum())
    assert dropped > 0                     # per-rank capacity drops
    np.testing.assert_allclose(y.numpy(), ref[f"{tag}/out"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref[f"{tag}/aux"]),
                               rtol=1e-6)


def _named(tree) -> dict:
    """{"a/0/b": tensor} of a parameter tree, in order."""
    return {"/".join(map(str, path)): t for path, t in flatten(tree)}


def _layer_grads(cfg, p, x, w, mesh):
    leaves = _named(p)
    for t in leaves.values():
        t.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    y, aux = tmoe.moe_apply(p, cfg, x, mesh=mesh)
    grads = torch.autograd.grad((y * w).sum() + aux,
                                [x] + list(leaves.values()))
    for t in leaves.values():
        t.requires_grad_(False)
    return y.detach(), aux.detach(), dict(zip(["x"] + list(leaves), grads))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh", [(MESHES[0], AXES, False),
                                  (MESHES[1], AXES, False),
                                  (MESHES[0], AXES, True), POD + (False,)],
                         ids=["2x4", "4x2", "2x4-listed", "pod-2x2x2"])
def test_expert_parallel_matches_reference_on_float_data(ref, arch, mesh):
    """Output and aux within 1e-5 of the reference's schedule and of
    ``moe_apply(n_groups=1)``; every gradient within relative L2 1e-5 of
    ``jax.grad``'s through the reference's schedule."""
    shape, axes, spread = mesh
    dims = _moe_dims(TCFGS[arch].moe)
    cfg, p, x, w = _port_layer(dims, FLOAT_CF, False, 2)
    tmesh = _mesh(shape, axes, spread)
    assert tmoe._expert_parallel_ok(cfg, x, tmesh)
    y, aux, grads = _layer_grads(cfg, p, x, w, tmesh)
    tag = f"float/{arch}/{_key(shape)}"
    for want, want_aux in ((ref[f"{tag}/out"], ref[f"{tag}/aux"]),
                           (ref[f"float/{arch}/out1"],
                            ref[f"float/{arch}/aux1"])):
        assert float(np.abs(y.numpy() - want).max()) < 1e-5
        assert abs(float(aux) - float(want_aux)) < 1e-5
    assert set(grads) == {"x", "router", "w_gate", "w_up", "w_down"} | (
        {"shared/w_gate", "shared/w_up", "shared/w_down"}
        if dims["n_shared"] else set())
    for name, g in grads.items():
        r = _rel(g, ref[f"{tag}/grad/{name}"])
        assert r <= 1e-5, (name, r)
    assert float(grads["router"].norm()) > 0


def _near_ties(probs: np.ndarray, k: int) -> int:
    srt = -np.sort(-probs, axis=1)
    kth, nxt = srt[:, k - 1], srt[:, k]
    return int(((kth - nxt) <= NEAR_TIE_RTOL * kth).sum())


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=_key)
def test_lm_loss_and_prefill_on_a_mesh_match_reference(
        ref, monkeypatch, arch, mesh_shape):
    """``lm_loss`` (loss, ce, aux, every gradient) and ``prefill``'s logits
    with a mesh within 1e-4 relative of the reference's under a
    ``ShardCtx``; every MoE layer ran the schedule, with no routing
    near-tie."""
    cfg = TCFGS[arch]
    params = lm_params_from_reference(_unflat(ref, f"lm/{arch}/param"), cfg,
                                      device="cpu")
    batch = {k: T(v) for k, v in _lm_batch(cfg.vocab, 4).items()}
    mesh = _mesh(mesh_shape)
    probs, calls = [], []
    real_route, real_ep = tmoe._route, tmoe.moe_apply_expert_parallel

    def route(p, c, x_flat):
        out = real_route(p, c, x_flat)
        probs.append(out[2].detach().numpy().copy())
        return out

    def ep(*args):
        calls.append(1)
        return real_ep(*args)
    monkeypatch.setattr(tmoe, "_route", route)
    monkeypatch.setattr(tmoe, "moe_apply_expert_parallel", ep)
    named = _named(params)
    flat = list(named.values())
    for t in flat:
        t.requires_grad_(True)
    loss, met = tt.lm_loss(cfg, params, batch, mesh)
    grads = torch.autograd.grad(loss, flat)
    loss, met = loss.detach(), {k: v.detach() for k, v in met.items()}
    for t in flat:
        t.requires_grad_(False)
    n_moe = cfg.n_layers - cfg.dense_prefix
    # The forward and the checkpoint's recompute, a rank each.
    assert len(calls) == 2 * n_moe
    assert len(probs) == 2 * n_moe * 8
    ties = sum(_near_ties(pr, cfg.moe.top_k) for pr in probs)
    assert ties == 0, f"{ties} routing near-ties"
    tag = f"lm/{arch}/{_key(mesh_shape)}"
    for name, v in (("loss", loss), ("ce", met["ce"]), ("aux", met["aux"])):
        np.testing.assert_allclose(float(v), float(ref[f"{tag}/{name}"]),
                                   rtol=1e-4)
    want = lm_params_from_reference(_unflat(ref, f"{tag}/grad"), cfg,
                                    device="cpu")
    grads = dict(zip(named, grads))
    for path, w in _named(want).items():
        r = _rel(grads[path], w)
        assert r <= 1e-4, (path, r)
    assert float(grads[f"layers/{cfg.n_layers - 1}/moe/router"].norm()) > 0
    logits = tt.prefill(cfg, params, batch["tokens"], mesh)
    assert _rel(logits.detach(), ref[f"{tag}/logits"]) <= 1e-4


def test_expert_parallel_ok_truth_table(ref):
    got = []
    for shape, axes in TRUTH_MESHES:
        mesh = make_mesh(shape, axes, device="cpu")
        for b, s, e in TRUTH_SHAPES:
            cfg = tmoe.MoeConfig(d_model=1, n_experts=e, top_k=1, d_expert=1)
            got.append(tmoe._expert_parallel_ok(cfg, torch.empty(b, s, 1),
                                                mesh))
    np.testing.assert_array_equal(np.asarray(got), ref["truth"])
    assert 0 < int(ref["truth"].sum()) < len(got)
    cfg = tmoe.MoeConfig(d_model=1, n_experts=8, top_k=1, d_expert=1)
    assert not tmoe._expert_parallel_ok(cfg, torch.empty(4, 16, 1), None)
    assert not bool(ref["truth_no_ctx"])
    assert tmoe._axis_size(make_mesh(*POD, device="cpu"),
                           ("pod", "data")) == 4
    assert tmoe._axis_size(make_mesh(*POD, device="cpu"), "model") == 2


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("case", GROUP_CASES, ids=[c[0] for c in
                                                   GROUP_CASES])
def test_moe_apply_without_the_schedule_takes_one_group_a_data_shard(
        ref, monkeypatch, arch, case):
    name, shape, axes, n_groups = case
    dims = _moe_dims(TCFGS[arch].moe)
    cfg, p, x, _ = _port_layer(dims, 1.0, True, 5, GROUP_SHAPE)
    mesh = make_mesh(shape, axes, device="cpu")
    assert not tmoe._expert_parallel_ok(cfg, x, mesh)
    seen = _port_ranks(monkeypatch)
    y, aux = tmoe.moe_apply(p, cfg, x, mesh=mesh)
    assert len(seen) == n_groups
    assert sum(int((~k).sum()) for _, _, k in seen) > 0
    np.testing.assert_allclose(y.numpy(), ref[f"groups/{arch}/{name}/out"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux),
                               float(ref[f"groups/{arch}/{name}/aux"]),
                               rtol=1e-6)
    # decode's no_drop never takes the schedule, on any mesh.
    seen.clear()
    tmoe.moe_apply(p, cfg, x, no_drop=True, mesh=_mesh((2, 2)))
    assert len(seen) == 2


def test_expert_parallel_capacity_is_per_rank():
    """cap = max(int(capacity_factor * t_local * k / E), 1) with t_local a
    rank's tokens; at capacity factor 1.0 the schedule keeps what
    ``moe_apply`` over the rank blocks as its groups keeps, and the
    output equals it."""
    dims = dict(d_model=16, n_experts=8, top_k=2, d_expert=12, n_shared=0,
                d_shared=0)
    cfg, p, x, _ = _port_layer(dims, 1.0, False, 9, (4, 8))
    mesh = _mesh((2, 2))
    caps, real = [], tmoe._dispatch_group
    try:
        tmoe._dispatch_group = lambda xg, e, cap, n: (
            caps.append((xg.shape[0], cap)) or real(xg, e, cap, n))
        y, aux = tmoe.moe_apply(p, cfg, x, mesh=mesh)
        # The same tokens laid out rank block by rank block.
        blocks = torch.cat([x[i * 2:(i + 1) * 2, j * 4:(j + 1) * 4]
                            .reshape(8, 16) for i, j, _ in
                            tmoe._ranks(mesh)])
        yg, auxg = tmoe.moe_apply(p, cfg, blocks[None], n_groups=4)
    finally:
        tmoe._dispatch_group = real
    # 8 tokens a rank: cap int(1.0 * 8 * 2 / 8) = 2, not the batch's 8.
    assert caps == [(8, 2)] * 8
    got = torch.cat([y[i * 2:(i + 1) * 2, j * 4:(j + 1) * 4].reshape(8, 16)
                     for i, j, _ in tmoe._ranks(mesh)])
    torch.testing.assert_close(got, yg[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(aux, auxg, rtol=1e-6, atol=1e-7)


def test_decode_and_dry_run_paths_take_no_mesh():
    """``decode_step`` has no mesh (its MoE is ``no_drop``), and the dry
    run's cells call ``lm_loss`` / ``prefill`` without one."""
    import inspect

    from repro_torch.launch import cells

    assert "mesh" not in inspect.signature(tt.decode_step).parameters
    src = inspect.getsource(cells)
    assert "tfm.lm_loss(cfg, p, batch)" in src
    assert "tfm.prefill(cfg, p, tokens)" in src


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    return torch.cuda.device_count()


def _card_layer(dev):
    dims = _moe_dims(TCFGS["deepseek-v2-lite"].moe)
    cfg, p, x, w = _port_layer(dims, FLOAT_CF, False, 2)
    return cfg, _tree(p, lambda t: t.to(dev)), x.to(dev), w.to(dev)


@pytest.mark.gpu
def test_expert_parallel_on_card_matches_cpu(cuda):
    """The (2, 4) mesh on one card: output, aux and gradients within
    relative 1e-5 of the same schedule on the CPU; ``topk`` launched once
    a rank."""
    cfg, p, x, w = _card_layer("cpu")
    want = _layer_grads(cfg, p, x, w, _mesh((2, 4)))
    cfg, p, x, w = _card_layer(cuda)
    ops.reset_launch_counts()
    got = _layer_grads(cfg, p, x, w, make_mesh((2, 4), AXES,
                                               devices="cuda:0"))
    assert ops.launch_counts()["topk"] == 8
    assert _rel(got[0].cpu(), want[0]) <= 1e-5
    assert abs(float(got[1]) - float(want[1])) <= 1e-5 * float(want[1])
    for name, g in got[2].items():
        assert _rel(g.cpu(), want[2][name]) <= 1e-5, name


@pytest.mark.gpu
def test_expert_parallel_over_every_card_equals_one_card(two_cards,
                                                          monkeypatch):
    """The (2, 4) mesh over every card: output and aux bit-identical to the
    same mesh on one card, gradients within relative 1e-6 (autograd sums
    the ranks' router gradients in the order they arrive), and ``topk``
    launched on each rank's own card."""
    one = make_mesh((2, 4), AXES, devices="cuda:0")
    every = make_mesh((2, 4), AXES)
    assert len(every.devices) == min(two_cards, 8)
    cfg, p, x, w = _card_layer(torch.device("cuda", 0))
    want = _layer_grads(cfg, p, x, w, one)
    devices, real = [], ops.topk

    def spy(d, k):
        devices.append(d.device)
        return real(d, k)
    monkeypatch.setattr(ops, "topk", spy)
    ops.reset_launch_counts()
    got = _layer_grads(cfg, p, x, w, every)
    assert ops.launch_counts()["topk"] == 8
    assert devices == [d for _, _, d in tmoe._ranks(every)]
    assert devices == list(every.shard_devices)
    assert got[0].device == x.device
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, g in got[2].items():
        assert g.device == x.device
        assert _rel(g.cpu(), want[2][name].cpu()) <= 1e-6, name


if __name__ == "__main__":
    if sys.argv[1:2] != ["ref"] or len(sys.argv) != 3:
        raise SystemExit("usage: test_torch_moe_ep.py ref OUT.npz")
    _reference(sys.argv[2])
