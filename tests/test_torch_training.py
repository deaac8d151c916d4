"""The port's training path against the reference's, on the CPU.

* Schedules (cosine, WSD, const) at every step, one ``adamw_update`` on
  the reference's stacked leaves (weight decay by the reference's rank:
  every tensor of a layer decays, as its stacked leaf does; ``ln_final``
  does not), the clip and its global norm.
* Int8 compression on the same gradients: codes, scales, dequantised
  values and error feedback bit-identical, one scale per stacked leaf of
  a stack group (``dense_layers`` / ``layers``), and the payload count.
* The data pipelines' draws, ``cross_entropy``, ``lm_loss`` and its
  gradients for the five LM archs (float32; bfloat16 for the dense
  three), three ``make_train_step`` steps with and without compression,
  ``ops.topk``'s value gradient against ``lax.top_k``'s, the
  per-layer checkpoint against a plain loop, checkpoints (round trip, bfloat16, latest / prune, async, a
  resume bit-identical to straight steps) and the launcher.
* ``gpu``-marked tests run on the card against the CPU; the reference is
  imported in a fixture, so they run without JAX.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import lm_params_from_reference  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import compression as tcomp  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
ARCHS = {"qwen2-7b": "qwen2_7b", "deepseek-coder-33b": "deepseek_coder_33b",
         "minicpm-2b": "minicpm_2b", "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
         "deepseek-v2-lite-16b": "deepseek_v2_lite_16b"}
DENSE = ("qwen2-7b", "deepseek-coder-33b", "minicpm-2b")
BATCH, SEQ = 2, 32
# bfloat16 lm_loss against the reference's: the loss within 1e-2
# relative; each gradient within BF16_GRAD relative L2 (the CPU shows
# at most about 1.5e-2 on the three dense smoke models).
BF16_LOSS, BF16_GRAD = 1e-2, 5e-2


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt
    from repro.training import compression as jcomp
    from repro.training import data as jdata
    from repro.training import optimizer as jopt
    mods = {a: importlib.import_module(f"repro.configs.{m}")
            for a, m in ARCHS.items()}
    # The reference's update and compression, jitted (eagerly each of
    # their ops would compile on its own).
    return dict(jax=jax, jnp=jnp, t=jt, opt=jopt, comp=jcomp, data=jdata,
                mods=mods, grad_fns={}, params={},
                adamw=jax.jit(jopt.adamw_update, static_argnums=0),
                compress=jax.jit(jcomp.compress_grads_with_feedback))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _models(jx, arch: str, dtype: str = "float32"):
    """The reference's smoke model (its ``init_lm``, float32 master
    weights) and the port's float32 copy."""
    jnp = jx["jnp"]
    jcfg = dataclasses.replace(jx["mods"][arch].SMOKE_CONFIG,
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tbase.get(arch).smoke_config,
                               dtype=getattr(torch, dtype))
    if jcfg not in jx["params"]:
        jx["params"][jcfg] = jx["jax"].jit(lambda k: jx["t"].init_lm(
            jcfg, k))(jx["jax"].random.PRNGKey(0))
    jp = jx["params"][jcfg]
    tp = lm_params_from_reference(jx["jax"].tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _grad_fn(jx, jcfg):
    """The reference's jitted value_and_grad of ``lm_loss`` (made once per
    config)."""
    if jcfg not in jx["grad_fns"]:
        jx["grad_fns"][jcfg] = jx["jax"].jit(jx["jax"].value_and_grad(
            lambda p, b: jx["t"].lm_loss(jcfg, p, b), has_aux=True))
    return jx["grad_fns"][jcfg]


def _port_grads(tcfg, tp, batch, loss_fn=tt.lm_loss):
    flat = list(tt.leaves(tp))
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = loss_fn(tcfg, tp, batch)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            topt.tree_map(lambda _: next(it), tp))


def _to_port(jx, tree, tcfg):
    """A tree in the reference's stacked layout -> the port's, float32."""
    return lm_params_from_reference(jx["jax"].tree.map(np.asarray, tree),
                                    tcfg, device="cpu")


def _batch(vocab: int, seed: int = 0) -> dict:
    b = next(iter(tdata.LmBatches(vocab, BATCH, SEQ, seed=seed,
                                  device="cpu")))
    b["labels"][0, :5] = -100
    return b


def _assert_trees_close(got, want, rtol: float, what: str):
    want = dict(topt.flatten(want))
    for path, a in topt.flatten(got):
        r = _rel(a.detach(), want.pop(path))
        assert r <= rtol, (what, path, r)
    assert not want, (what, sorted(want))


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_match_reference(jx, schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=60, schedule=schedule)
    ours, theirs = topt.AdamWConfig(**kw), jx["opt"].AdamWConfig(**kw)
    f, g = topt.schedule_fn(ours), jx["opt"].schedule_fn(theirs)
    for step in range(0, kw["total_steps"] + 11):
        got = f(torch.tensor(step, dtype=torch.int32))
        want = g(jx["jnp"].asarray(step, jx["jnp"].int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0, err_msg=f"step {step}")


def _random_like(jx, tree, seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return jx["jax"].tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        tree)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-lite-16b",
                                  "qwen3-moe-30b-a3b"])
def test_adamw_update_matches_reference_leaf_by_leaf(jx, arch):
    """Two updates from the same numpy parameters and gradients (stacked
    norms and qwen2's QKV bias included): parameters and both moments
    within 1e-6 of each tensor's largest magnitude, and the step counters
    equal."""
    jcfg, jp, tcfg, tp = _models(jx, arch)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1e9,
                  weight_decay=0.1)
    jc, tc = jx["opt"].AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    js, ts = jx["opt"].adamw_init(jp), topt.adamw_init(tp)
    for i in range(2):
        jg = _random_like(jx, jp, seed=10 + i, scale=0.1)
        tg = _to_port(jx, jg, tcfg)
        jp, js, jm = jx["adamw"](jc, jp, jg, js)
        tp, ts, tm = topt.adamw_update(tc, tp, tg, ts)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        want = _to_port(jx, want, tcfg)
        for (path, a), (_, b) in zip(topt.flatten(got),
                                     topt.flatten(want)):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=1e-6 * float(b.abs().max()), err_msg=str(path))


def test_weight_decay_follows_the_reference_stacked_rank():
    """With zero gradients an update is decay alone: every tensor of a
    layer (norm gammas, QKV biases, q/k norms, MoE router) shrinks by
    lr * wd, as the reference's stacked (L, ...) leaf does; ``ln_final``,
    a top-level vector, does not move."""
    for arch in ("qwen2-7b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"):
        cfg = tbase.get(arch).smoke_config
        p = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
        for lp in p["layers"]:
            lp["ln_attn"].uniform_(0.5, 1.5)
        p["ln_final"].uniform_(0.5, 1.5)
        before = topt.tree_map(torch.clone, p)
        oc = topt.AdamWConfig(lr=0.5, schedule="const", weight_decay=0.1)
        topt.adamw_update(oc, p, topt.tree_map(torch.zeros_like, p),
                          topt.adamw_init(p))
        for (path, a), (_, b) in zip(topt.flatten(p),
                                     topt.flatten(before)):
            if path == ("ln_final",):
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b * (1 - 0.5 * 0.1),
                                           rtol=1e-6, atol=0, msg=str(path))
        names = {n: stacked for n, _, stacked in topt.reference_leaves(p)}
        assert names["ln_final"] is False and names["embed"] is False
        assert names["layers/ln_attn"] is True
        assert ("dense_layers/ffn/w_gate" in names) == (
            cfg.dense_prefix > 0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_and_global_norm_match_reference(jx, max_norm):
    _, jp, tcfg, _ = _models(jx, "minicpm-2b")
    jg = _random_like(jx, jp, seed=3)
    tg = _to_port(jx, jg, tcfg)
    want, wnorm = jx["opt"].clip_by_global_norm(jg, max_norm)
    got, norm = topt.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    _assert_trees_close(got, _to_port(jx, want, tcfg), 1e-6, "clip")


# ------------------------------------------------------------- compression

def _stack_groups(seed: int, scale: float):
    """A small gradient tree of an MoE net with a dense first layer, in
    both layouts: the port's three layer dicts, the reference's
    ``dense_layers`` (one layer) and ``layers`` (two) stacks."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    dense = {"ln_ffn": arr(1, 6), "ffn": {"w_up": arr(1, 6, 10)}}
    moe = {"ln_ffn": arr(2, 6), "moe": {"router": arr(2, 6, 4),
                                        "shared": {"w_up": arr(2, 6, 8)}}}
    ref = {"embed": arr(12, 6), "dense_layers": dense, "layers": moe,
           "ln_final": arr(6)}
    port = {"embed": T(ref["embed"]), "ln_final": T(ref["ln_final"]),
            "layers": [
                topt.tree_map(lambda a: T(a[0].copy()), dense),
                *[topt.tree_map(lambda a, i=i: T(a[i].copy()), moe)
                  for i in range(2)]]}
    return ref, port


def test_compression_bit_identical_per_stacked_leaf(jx):
    """Gradients plus error feedback on the same numpy values, the
    reference called eagerly (op by op, as written): each reference leaf's
    scale (one per stacked leaf of a stack group), its int8 codes, the
    dequantised gradients and the new error feedback equal the
    reference's bit for bit; the payload count is the reference's at
    full width too."""
    jcomp = jx["comp"]
    jg, tg = _stack_groups(4, 0.01)
    je, te = _stack_groups(5, 1e-4)
    # Values near the halves of the router's step (round half to even).
    half = np.float32([0.5, 1.5, -2.5]) * np.float32(
        np.abs(jg["layers"]["moe"]["router"]).max() / 127.0)
    jg["layers"]["moe"]["router"][0, 0, :3] = half
    je["layers"]["moe"]["router"][0, 0, :3] = 0.0
    tg["layers"][1]["moe"]["router"][0, :3] = T(half)
    te["layers"][1]["moe"]["router"][0, :3] = 0.0
    jleaves = dict(
        ("/".join(str(k.key) for k in path), leaf) for path, leaf in
        jx["jax"].tree_util.tree_flatten_with_path(
            jx["jax"].tree.map(lambda g, e: g + e, jg, je))[0])
    summed = {name: [g + e for g, e in zip(gs, es)] for (name, gs, _), (
        _, es, _) in zip(topt.reference_leaves(tg),
                         topt.reference_leaves(te))}
    assert set(summed) == set(jleaves)
    assert len(summed["layers/moe/router"]) == 2
    assert len(summed["dense_layers/ffn/w_up"]) == 1
    for name, parts in summed.items():
        wq, ws = jcomp.quantize_leaf(jleaves[name])
        scale = tcomp.leaf_scale(parts)
        assert float(scale) == float(ws), name
        codes = np.stack([tcomp.quantize_with_scale(p, scale).numpy()
                          for p in parts])
        np.testing.assert_array_equal(codes.reshape(np.shape(wq)),
                                      np.asarray(wq))
    want_g, want_e = jcomp.compress_grads_with_feedback(jg, je)
    got_g, got_e = tcomp.compress_grads_with_feedback(tg, te)
    for got, want in ((got_g, want_g), (got_e, want_e)):
        want = {"embed": want["embed"], "ln_final": want["ln_final"],
                "layers": [topt.tree_map(lambda a: np.asarray(a)[0],
                                         want["dense_layers"]),
                           *[topt.tree_map(lambda a, i=i: np.asarray(a)[i],
                                           want["layers"])
                             for i in range(2)]]}
        want = dict(topt.flatten(want))
        for path, a in topt.flatten(got):
            np.testing.assert_array_equal(a.numpy(), np.asarray(want[path]),
                                          err_msg=str(path))
    for arch in ("deepseek-v2-lite-16b", "qwen2-7b"):
        cfg = tbase.get(arch).config
        assert tcomp.compressed_allreduce_bytes(
            tt.init_lm(cfg, None, device="meta")) == \
            jcomp.compressed_allreduce_bytes(jx["jax"].eval_shape(
                lambda k, c=jx["mods"][arch].CONFIG: jx["t"].init_lm(c, k),
                jx["jax"].random.PRNGKey(0)))
    # One tensor: the reference's quantize_leaf / dequantize_leaf.
    x = np.random.default_rng(6).standard_normal((7, 9)).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 127.0]
    q, s = tcomp.quantize_leaf(T(x))
    wq, ws = jcomp.quantize_leaf(jx["jnp"].asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(tcomp.dequantize_leaf(q, s).numpy(),
                                  np.asarray(jcomp.dequantize_leaf(wq, ws)))


# -------------------------------------------------------------------- data

def test_data_pipelines_draw_the_reference_values(jx):
    jd = jx["data"]
    pairs = [
        (tdata.LmBatches(500, 3, 9, seed=2, device="cpu"),
         jd.LmBatches(500, 3, 9, seed=2)),
        (tdata.DlrmBatches((50, 7, 1000), 5, 4, seed=1, device="cpu"),
         jd.DlrmBatches((50, 7, 1000), 5, 4, seed=1)),
        (tdata.SeqRecBatches(300, 4, 12, n_mask=3, seed=3,
                             device="cpu").mind_iter(),
         jd.SeqRecBatches(300, 4, 12, n_mask=3, seed=3).mind_iter()),
        (tdata.SeqRecBatches(300, 4, 12, n_mask=3, seed=3,
                             device="cpu").bert4rec_iter(299),
         jd.SeqRecBatches(300, 4, 12, n_mask=3, seed=3).bert4rec_iter(299)),
    ]
    for ours, theirs in pairs:
        ours, theirs = iter(ours), iter(theirs)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert set(a) == set(b)
            for k in a:
                assert isinstance(a[k], torch.Tensor)
                want = np.asarray(b[k])
                assert a[k].numpy().dtype == want.dtype, k
                np.testing.assert_array_equal(a[k].numpy(), want, err_msg=k)
    for got, want in zip(tdata.random_graph_data(200, 900, 6, 5, seed=4),
                         jd.random_graph_data(200, 900, 6, 5, seed=4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------------- loss

def test_cross_entropy_matches_reference(jx):
    from repro.models import layers as jlayers

    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 41)) * 4).astype(np.float32)
    labels = rng.integers(0, 41, (3, 7)).astype(np.int32)
    mask = rng.uniform(size=(3, 7)) < 0.6
    for m in (mask, None, np.zeros_like(mask)):
        got = tlayers.cross_entropy(T(logits), T(labels),
                                    None if m is None else T(m))
        want = jlayers.cross_entropy(logits, labels, m)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)
    got = tlayers.cross_entropy(T(logits).bfloat16(), T(labels), T(mask))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_loss_and_grads_match_reference_f32(jx, arch):
    """Loss, ce and aux within 1e-5 relative, each gradient within 1e-4
    relative L2 of ``jax.grad``'s (mapped through the stacking); the MoE
    router's gradient comes through ``ops.topk``'s value gradient."""
    jcfg, jp, tcfg, tp = _models(jx, arch)
    batch = _batch(tcfg.vocab)
    (jl, jm), jg = _grad_fn(jx, jcfg)(
        jp, {k: v.numpy() for k, v in batch.items()})
    tl, tm, tg = _port_grads(tcfg, tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-7)
    assert (float(tm["aux"]) > 0) == (tcfg.moe is not None)
    _assert_trees_close(tg, _to_port(jx, jg, tcfg), 1e-4, arch)
    if tcfg.moe is not None:
        router = tg["layers"][-1]["moe"]["router"]
        assert float(router.norm()) > 0


@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_grads_match_reference_bf16(jx, arch):
    jcfg, jp, tcfg, tp = _models(jx, arch, "bfloat16")
    batch = _batch(tcfg.vocab)
    (jl, _), jg = _grad_fn(jx, jcfg)(
        jp, {k: v.numpy() for k, v in batch.items()})
    tl, _, tg = _port_grads(tcfg, tp, batch)
    assert abs(float(tl) - float(jl)) <= BF16_LOSS * abs(float(jl))
    _assert_trees_close(tg, _to_port(jx, jg, tcfg), BF16_GRAD, arch)


def test_topk_value_gradient_matches_lax_top_k(jx):
    """The router's form: ``-ops.topk(-probs, k)`` values against
    ``lax.top_k(probs, k)``, ties included (a uniform row, repeated
    levels): equal values and ids, and the gradient of a weighted sum of
    the values equal to ``jax.grad``'s."""
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    x[0] = 0.25
    x[1] = np.repeat(rng.standard_normal(6), 4).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(x, axis=-1))
    w = rng.standard_normal((16, 5)).astype(np.float32)

    def jloss(p):
        v, _ = jax.lax.top_k(p, 5)
        return jnp.sum(v * w)

    jv, ji = jax.lax.top_k(probs, 5)
    pt = T(probs.copy()).requires_grad_(True)
    nv, ids = ops.topk(-pt, 5)
    np.testing.assert_array_equal((-nv).detach().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    (g,) = torch.autograd.grad((-nv * T(w)).sum(), pt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax.grad(jloss)(
        probs)))
    assert not ids.requires_grad


def _plain_lm_loss(cfg, params, batch):
    """``lm_loss`` with a plain loop over ``_train_layer`` (no
    checkpoint)."""
    x = tt._embed(cfg, params, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_layer in params["layers"]:
        x, aux = tt._train_layer(cfg, p_layer, x, aux)
    x = tlayers.rms_norm(x, params["ln_final"].to(x.dtype))
    logits = tt.logits_from_hidden(cfg, params, x)
    labels = batch["labels"]
    ce = tlayers.cross_entropy(logits, labels.clamp_min(0), labels >= 0)
    return ce + cfg.aux_loss_weight * aux, {"ce": ce, "aux": aux}


@pytest.fixture
def checkpoint_calls(monkeypatch):
    """Counts ``torch.utils.checkpoint.checkpoint`` calls (each still
    runs)."""
    real, calls = torch.utils.checkpoint.checkpoint, []

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    return calls


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-lite-16b"])
def test_remat_on_and_off_bit_identical(arch, checkpoint_calls):
    """``forward`` checkpoints every layer when autograd records, and its
    loss and gradients equal a plain loop over ``_train_layer`` bit for
    bit; with no parameter requiring grad (serving) it checkpoints none."""
    cfg = tbase.get(arch).smoke_config
    p = tt.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu",
                   dtype=torch.float32)
    batch = _batch(cfg.vocab, seed=1)
    on = _port_grads(cfg, p, batch)
    assert len(checkpoint_calls) == cfg.n_layers
    off = _port_grads(cfg, p, batch, loss_fn=_plain_lm_loss)
    assert len(checkpoint_calls) == cfg.n_layers
    assert torch.equal(on[0], off[0])
    for (path, a), (_, b) in zip(topt.flatten(on[2]), topt.flatten(off[2])):
        assert torch.equal(a, b), path
    tt.forward(cfg, p, batch["tokens"])  # grad on, nothing requires it
    assert len(checkpoint_calls) == cfg.n_layers


def test_topk_records_only_where_grad_is_needed():
    """``ops.topk`` goes through its autograd function only where the
    input requires grad; the values are the same either way."""
    d = T(np.random.default_rng(0).normal(size=(16, 40)).astype(np.float32))
    v0, i0 = ops.topk(d, 5)
    assert v0.grad_fn is None
    v1, i1 = ops.topk(d.clone().requires_grad_(True), 5)
    assert v1.grad_fn is not None and not i1.requires_grad
    assert torch.equal(v0, v1.detach()) and torch.equal(i0, i1)
    with torch.no_grad():
        v2, _ = ops.topk(d.clone().requires_grad_(True), 5)
    assert v2.grad_fn is None and torch.equal(v0, v2)


# -------------------------------------------------------------- train step

def _ref_step(jx, jcfg, opt_cfg, compress: bool):
    """The reference's ``make_train_step`` body: value_and_grad, the
    compression and ``adamw_update``, each jitted on its own.  With
    ``grads_of`` given (a function of the step's batch), the compression
    and the update take those gradients, the port's, in the reference's
    layout."""
    grad = _grad_fn(jx, jcfg)

    def step(state, batch, grads_of=None):
        (loss, metrics), grads = grad(state.params, batch)
        if grads_of is not None:
            grads = grads_of(batch)
        err = state.error_feedback
        if compress:
            grads, err = jx["compress"](grads, err)
        params, opt, om = jx["adamw"](opt_cfg, state.params, grads,
                                      state.opt)
        return (dataclasses.replace(state, params=params, opt=opt,
                                    error_feedback=err),
                dict(metrics, **om, loss=loss))
    return step


def _to_reference(tree, tcfg):
    """The port's tree -> the reference's stacked numpy layout."""
    out = {k: v.detach().numpy() for k, v in tree.items() if k != "layers"}
    kd = tcfg.dense_prefix
    groups = (("dense_layers", tree["layers"][:kd]),
              ("layers", tree["layers"][kd:]))
    for name, ls in groups:
        if ls:
            out[name] = topt.tree_map(
                lambda *xs: np.stack([x.detach().numpy() for x in xs]),
                *ls)
    return out


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch,schedule", [("minicpm-2b", "wsd"),
                                           ("deepseek-v2-lite-16b",
                                            "cosine")])
def test_three_train_steps_match_reference(jx, arch, schedule, compress):
    """Per-step loss, ce, aux, lr and grad_norm within 1e-5, and each
    parameter within 1e-5 relative L2 after three steps, at the
    launcher's learning rate.  AdamW moves an element by about lr
    whatever its gradient's size, so an element whose gradient nearly
    cancels (|g| near eps) moves by a share of lr that follows its
    gradient's last digits: the gap in the parameters scales with lr.
    With compression a gradient's last digits also flip an int8 code
    wherever g / scale lies near a half, moving that element by about lr;
    so there the reference's compression and update take the port's
    gradients of each step (the gradients themselves are held to the
    reference's by the ``lm_loss`` tests), and the error feedback is
    compared too, within 1e-4."""
    from repro.training import train_step as jts

    jcfg, jp, tcfg, tp = _models(jx, arch)
    kw = dict(lr=3e-4, warmup_steps=1, total_steps=4, schedule=schedule)
    jstep = _ref_step(jx, jcfg, jx["opt"].AdamWConfig(**kw), compress)
    tstep = tts.make_train_step(lambda p, b: tt.lm_loss(tcfg, p, b),
                                topt.AdamWConfig(**kw), compress)
    js = jts.init_train_state(jp, compress_grads=compress)
    ts = tts.init_train_state(tp, compress_grads=compress)
    data = iter(tdata.LmBatches(tcfg.vocab, BATCH, SEQ, seed=5,
                                device="cpu"))
    for _ in range(3):
        b = next(data)
        grads_of = None
        if compress:
            port = _port_grads(tcfg, ts.params, b)[2]
            grads_of = lambda _b, g=port: _to_reference(g, tcfg)  # noqa
        js, jm = jstep(js, {k: v.numpy() for k, v in b.items()}, grads_of)
        ts, tm = tstep(ts, b)
        for k in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(ts.step) == 3
    _assert_trees_close(ts.params, _to_port(jx, js.params, tcfg), 1e-5,
                        "params")
    if compress:
        # The jitted reference fuses g - q * scale into one multiply-add:
        # its residual misses the rounding of q * scale (the eager one's
        # is bit-identical, test_compression_bit_identical_per_stacked_leaf).
        _assert_trees_close(ts.error_feedback,
                            _to_port(jx, js.error_feedback, tcfg), 1e-4,
                            "error feedback")
        assert any(float(e.abs().max()) > 0 for _, e in
                   topt.flatten(ts.error_feedback))


# -------------------------------------------------------------- checkpoint

def _state(seed=0, compress=False):
    cfg = tbase.get("deepseek-v2-lite-16b").smoke_config
    p = tt.init_lm(cfg, torch.Generator().manual_seed(seed), device="cpu",
                   dtype=torch.float32)
    return cfg, tts.init_train_state(p, compress_grads=compress)


def test_checkpoint_round_trip_with_bfloat16(tmp_path):
    tree = {"a": torch.randn(3, 4), "b": [torch.randn(2).bfloat16(),
                                         {"c": torch.arange(5,
                                                            dtype=torch.int32)}],
            "d": torch.tensor(7, dtype=torch.int32)}
    out = tckpt.save_checkpoint(tmp_path, 12, tree, extra={"note": "x"})
    assert out.name == "step_00000012" and not list(tmp_path.glob(".tmp*"))
    import json
    man = json.loads((out / "manifest.json").read_text())
    assert man["step"] == 12 and man["extra"] == {"note": "x"}
    kinds = {m["name"]: m["dtype"] for m in man["leaves"]}
    assert kinds["b_0"] == "bfloat16" and kinds["b_1_c"] == "int32"
    assert np.load(out / "b_0.npy").dtype == np.uint16
    target = topt.tree_map(torch.zeros_like, tree)
    back, step = tckpt.restore_checkpoint(tmp_path, target)
    assert step == 12
    for (path, a), (_, b) in zip(topt.flatten(back), topt.flatten(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_latest_prune_and_missing(tmp_path):
    assert tckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(tmp_path, {"a": torch.zeros(1)})
    for s in (1, 5, 9, 30):
        tckpt.save_checkpoint(tmp_path, s, {"a": torch.full((1,), float(s))})
    assert tckpt.latest_step(tmp_path) == 30
    tckpt.prune_old(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000009", "step_00000030"]
    back, s = tckpt.restore_checkpoint(tmp_path, {"a": torch.zeros(1)},
                                       step=9)
    assert s == 9 and float(back["a"][0]) == 9.0


def test_async_checkpoint_holds_the_state_at_save(tmp_path):
    """The tree is copied to the host before the thread starts: updating
    the tensors in place right after ``save`` does not reach the files."""
    _, st = _state(compress=True)
    want = topt.tree_map(torch.clone, dataclasses.asdict(st))
    saver = tckpt.AsyncCheckpointer()
    saver.save(tmp_path, 3, st)
    for _, t in topt.flatten(st):
        t.add_(1)
    saver.wait()
    back, step = tckpt.restore_checkpoint(tmp_path, st)
    assert step == 3 and isinstance(back, tts.TrainState)
    for (path, a), (_, b) in zip(topt.flatten(back), topt.flatten(want)):
        assert torch.equal(a, b), path


def test_checkpoint_errors_are_raised(tmp_path):
    """A leaf of another shape in the target raises; a write that failed
    in the async saver's thread raises from ``wait``."""
    tckpt.save_checkpoint(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(tmp_path, {"a": torch.zeros(4)})
    blocker = tmp_path / "file"
    blocker.write_text("")
    saver = tckpt.AsyncCheckpointer()
    saver.save(blocker / "sub", 2, {"a": torch.zeros(1)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                       # the error is raised once


def test_resume_is_bit_identical_to_straight_steps(tmp_path):
    """Three steps, a checkpoint, a restore into a fresh state, two more
    steps: bit for bit the state and losses of five straight steps
    (compression on, so the error feedback is restored too)."""
    def run(steps, state, data, step_fn):
        losses = []
        for _ in range(steps):
            state, m = step_fn(state, next(data))
            losses.append(float(m["loss"]))
        return state, losses

    cfg, _ = _state()
    step_fn = tts.make_train_step(
        lambda p, b: tt.lm_loss(cfg, p, b),
        topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5), True)
    batches = list(_take(tdata.LmBatches(cfg.vocab, 2, 16, seed=9,
                                         device="cpu"), 5))
    straight, l5 = run(5, _state(compress=True)[1], iter(batches), step_fn)
    data = iter(batches)
    first, l3 = run(3, _state(compress=True)[1], data, step_fn)
    tckpt.save_checkpoint(tmp_path, 3, first)
    fresh = _state(seed=7, compress=True)[1]
    restored, at = tckpt.restore_checkpoint(tmp_path, fresh)
    assert at == 3 and int(restored.step) == 3
    resumed, l2 = run(2, restored, data, step_fn)
    assert l3 + l2 == l5
    for (path, a), (_, b) in zip(topt.flatten(resumed),
                                 topt.flatten(straight)):
        assert torch.equal(a, b), path


def _take(it, n):
    it = iter(it)
    return [next(it) for _ in range(n)]


# ------------------------------------------------------------- entry point

def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train

    args = ["--device", "cpu", "--arch", "minicpm-2b", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--log-every", "2"]
    losses = train.main(args + ["--steps", "4"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert tckpt.latest_step(tmp_path) == 4
    more = train.main(args + ["--steps", "6", "--resume"])
    text = capsys.readouterr().out
    assert "[train] resumed from step 4" in text and "step=6" in text
    assert len(more) == 2 and all(np.isfinite(more))
    assert tckpt.latest_step(tmp_path) == 6
    oc = train.train_config("minicpm-2b", 3e-4, 100)
    assert oc.schedule == "wsd" and oc.warmup_steps == 5
    assert train.train_config("qwen2-7b", 3e-4, 400).schedule == "cosine"
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", "minicpm-2b", "--steps", "1"])


# ---------------------------------------------------------------- on card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_router_gradient_on_card_matches_cpu(card):
    """``ops.topk`` on the card (the kernel) inside a float32 MoE layer at
    4,096 tokens: values, ids and the router's gradient against the CPU
    (``topk_ref``) on the same inputs."""
    from repro_torch.models import moe as tmoe

    cfg = tmoe.MoeConfig(d_model=64, n_experts=64, top_k=6, d_expert=32,
                         n_shared=1)
    g = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(g, cfg, device="cpu")
    x = torch.randn((2, 2048, 64), generator=g)
    out = {}
    ops.reset_launch_counts()
    for dev in ("cpu", card):
        pp = topt.tree_map(lambda t: t.to(dev).requires_grad_(True), p)
        y, aux = tmoe.moe_apply(pp, cfg, x.to(dev))
        (gr,) = torch.autograd.grad((y.float() ** 2).mean(), pp["router"])
        out[str(dev)] = gr.cpu()
    assert ops.launch_counts()["topk"] == 1
    assert _rel(out[str(card)], out["cpu"]) <= 1e-5
    assert float(out["cpu"].norm()) > 0


def _card_setup():
    cfg = tbase.get("deepseek-v2-lite-16b").smoke_config
    batches = _take(tdata.LmBatches(cfg.vocab, 2, 32, seed=2, device="cpu"),
                    2)
    p = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu",
                   dtype=torch.float32)
    return cfg, batches, p


@pytest.mark.gpu
def test_remat_on_and_off_on_card(card, checkpoint_calls):
    """deepseek-v2-lite's smoke config on the card (the router on the
    ``topk`` kernel): the checkpointed ``forward`` and a plain loop over
    ``_train_layer`` give the same loss, and gradients within 1e-6
    relative L2."""
    cfg, batches, p = _card_setup()
    on_card = topt.tree_map(lambda t: t.to(card), p)
    batch = {k: v.to(card) for k, v in batches[0].items()}
    grads = {True: _port_grads(cfg, on_card, batch),
             False: _port_grads(cfg, on_card, batch,
                                loss_fn=_plain_lm_loss)}
    assert len(checkpoint_calls) == cfg.n_layers
    assert torch.equal(grads[True][0], grads[False][0])
    for (path, a), (_, b) in zip(topt.flatten(grads[True][2]),
                                 topt.flatten(grads[False][2])):
        assert _rel(a.cpu(), b.cpu()) <= 1e-6, path


@pytest.mark.gpu
def test_two_train_steps_on_card_match_cpu(card):
    """Two ``make_train_step`` steps of deepseek-v2-lite's smoke config on
    the card against the CPU: losses within 1e-4, parameters within 1e-4
    relative L2."""
    cfg, batches, p = _card_setup()
    on_card = topt.tree_map(lambda t: t.to(card), p)
    oc = topt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    step = tts.make_train_step(lambda q, b: tt.lm_loss(cfg, q, b), oc)
    states = {"cpu": tts.init_train_state(p),
              "cuda": tts.init_train_state(on_card)}
    for b in batches:
        ms = {d: step(s, {k: v.to(d) for k, v in b.items()})[1]
              for d, s in states.items()}
        np.testing.assert_allclose(float(ms["cuda"]["loss"]),
                                   float(ms["cpu"]["loss"]), rtol=1e-4)
    for (path, a), (_, b) in zip(topt.flatten(states["cuda"].params),
                                 topt.flatten(states["cpu"].params)):
        assert _rel(a.cpu(), b) <= 1e-4, path
