"""The LM zoo's four newer archs (deepseek-v2-lite-16b, qwen3-moe-30b-a3b,
deepseek-coder-33b, minicpm-2b) in the port against the reference, on the
reference's own ``SMOKE_CONFIG`` and its ``init_lm`` parameters carried
across by ``lm_params_from_reference``.

* ``decode_step`` logits over 12 positions and the caches, ``forward``'s
  hidden states and aux loss, and ``prefill``: float32 within 1e-4; in
  bfloat16 logits within a relative L2 error of 3e-2 and caches within
  1e-2, the bounds ``tests/test_torch_models.py`` states.  An MoE router
  in bfloat16 can send a near-tied token to another expert in either
  framework: both routers are watched, a decode position or prefill row
  beyond the bound is excused only where their expert choices differ for
  it, and at most one is.
* GQA with qwen3's per-head q/k RMS norm against the reference (non-unit
  norm weights), decode and train.
* minicpm's tied head and scaling knobs: no ``lm_head``, the logits are
  ``hidden @ embed.T * dim_model_base / d_model``, the embedding scaled by
  ``scale_emb`` and each residual branch by ``scale_depth / sqrt(L)``.
* The config dataclasses field for field against the reference's (the
  reference's XLA-only knobs excepted, listed in ``TPU_ONLY``), the shape
  cells, and at full width ``n_params()`` on the meta device equal to the
  reference's, with ``n_active_params()`` for the MoE archs.
* A ``gpu``-marked test runs deepseek-v2-lite's smoke config through
  ``decode_step`` on the card against the CPU in bfloat16 (the reference
  is imported in a fixture, so the file runs without JAX on the card).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import deepseek_coder_33b  # noqa: E402
from repro_torch.configs import deepseek_v2_lite_16b  # noqa: E402
from repro_torch.configs import minicpm_2b  # noqa: E402
from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import lm_params_from_reference  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
ARCHS = {"deepseek-v2-lite-16b": deepseek_v2_lite_16b,
         "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
         "deepseek-coder-33b": deepseek_coder_33b,
         "minicpm-2b": minicpm_2b}
# The reference's module of each arch.
REF_MODULES = {"deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
               "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
               "deepseek-coder-33b": "deepseek_coder_33b",
               "minicpm-2b": "minicpm_2b"}
FULL_PARAMS = {"deepseek-v2-lite-16b": 15_706_484_224,
               "qwen3-moe-30b-a3b": 30_532_122_624,
               "deepseek-coder-33b": 33_342_991_360,
               "minicpm-2b": 2_725_173_504}
ACTIVE_PARAMS = {"deepseek-v2-lite-16b": 2_661_150_208,
                 "qwen3-moe-30b-a3b": 3_353_032_704}
# XLA scheduling knobs of the reference's configs, absent from the port's:
# they change how XLA lowers the computation, not what it computes.
TPU_ONLY = {"remat", "unroll_layers", "attn_unroll", "skip_masked_blocks"}
DECODE_STEPS = 12


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import importlib

    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.models import attention as jattn
    from repro.models import transformer as jt
    mods = {a: importlib.import_module(f"repro.configs.{m}")
            for a, m in REF_MODULES.items()}
    return dict(jax=jax, jnp=jnp, t=jt, attn=jattn, base=jbase, mods=mods)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


_MODELS: dict = {}


def _models(jx, arch: str, dtype: str, seed: int = 0):
    """The reference's smoke model and the port's copy of its parameters
    (made once per arch, dtype and seed; neither side writes to them)."""
    key = (arch, dtype, seed)
    if key not in _MODELS:
        _MODELS[key] = _make_models(jx, arch, dtype, seed)
    return _MODELS[key]


def _make_models(jx, arch: str, dtype: str, seed: int):
    jnp = jx["jnp"]
    jcfg = dataclasses.replace(jx["mods"][arch].SMOKE_CONFIG,
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(ARCHS[arch].SMOKE_CONFIG,
                               dtype=getattr(torch, dtype))
    jp = jx["jax"].jit(lambda k: jx["t"].init_lm(jcfg, k))(
        jx["jax"].random.PRNGKey(seed))
    tp = lm_params_from_reference(jx["jax"].tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _ref_cache(jx, jc):
    """The reference's cache as one stack over all layers, in order."""
    jnp = jx["jnp"]
    if "dense" in jc:
        return {k: jnp.concatenate([jc["dense"][k], jc["scanned"][k]])
                for k in jc["dense"]}
    return jc


def _decode_both(jx, jcfg, jp, tcfg, tp, toks, max_len):
    jnp, jt = jx["jnp"], jx["t"]
    b, s = toks.shape
    jc = jt.init_cache(jcfg, b, max_len, dtype=jcfg.dtype)
    tc = tt.init_cache(tcfg, b, max_len, dtype=tcfg.dtype, device="cpu")
    step = jx["jax"].jit(lambda p, c, t, l: jt.decode_step(jcfg, p, c, t, l))
    jl, tl = [], []
    for t in range(s):
        lens = np.full((b,), t, np.int32)
        a, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(lens))
        c, tc = tt.decode_step(tcfg, tp, tc, T(toks[:, t:t + 1]).long(),
                               T(lens))
        jl.append(_np(a))
        tl.append(c.float().numpy())
    return np.stack(jl, 1), np.stack(tl, 1), _ref_cache(jx, jc), tc


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_forward_prefill_match_reference_f32(jx, arch):
    jnp, jt = jx["jnp"], jx["t"]
    jcfg, jp, tcfg, tp = _models(jx, arch, "float32")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, DECODE_STEPS)).astype(np.int32)
    jl, tl, jc, tc = _decode_both(jx, jcfg, jp, tcfg, tp, toks, 16)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert set(tc) == set(jc)
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   rtol=1e-4, atol=1e-4)
    long = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 32)).astype(
        np.int32)
    x, jaux = jx["jax"].jit(lambda p, t: jt.forward(jcfg, p, t))(
        jp, jnp.asarray(long))
    tx, taux = tt.forward(tcfg, tp, T(long).long())
    np.testing.assert_allclose(tx.numpy(), _np(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    if tcfg.moe is not None:
        assert float(taux) > 0.0
    else:
        assert float(taux) == 0.0
    np.testing.assert_allclose(
        tt.prefill(tcfg, tp, T(long).long()).numpy(),
        _np(jx["jax"].jit(lambda p, t: jt.prefill(jcfg, p, t))(
            jp, jnp.asarray(long))), rtol=1e-4, atol=1e-4)


def _routes_both(jx, monkeypatch):
    """Wrap both frameworks' routers: each call's (T, k) expert ids, sorted
    along k, appended to the port's list and (through an ordered host
    callback, which also runs inside the reference's jitted layer scan) to
    the reference's list."""
    from repro.models import moe as jmoe

    port, ref = [], []
    real, jreal = tmoe._route, jmoe._route

    def spy(p, cfg, x):
        out = real(p, cfg, x)
        port.append(np.sort(out[0].numpy(), -1))
        return out

    def jspy(p, cfg, x):
        out = jreal(p, cfg, x)
        jx["jax"].debug.callback(
            lambda e: ref.append(np.sort(np.asarray(e), -1)), out[0],
            ordered=True)
        return out
    monkeypatch.setattr(tmoe, "_route", spy)
    monkeypatch.setattr(jmoe, "_route", jspy)
    return port, ref


def _route_differs(port: list, ref: list) -> np.ndarray:
    """(calls, T): whether the two frameworks chose other experts for a
    token at each router call."""
    assert len(port) == len(ref) and all(
        a.shape == b.shape for a, b in zip(port, ref))
    return np.stack([(a != b).any(-1) for a, b in zip(port, ref)])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_and_prefill_match_reference_bf16(jx, monkeypatch, arch):
    """Logits within 3e-2 relative L2 and caches within 1e-2.  A bfloat16
    router rounds its logits to 2^-8 relative, so a token whose k-th and
    (k+1)-th experts are near-tied can go to another expert in each
    framework; such a flip moves the logits it reaches by about 0.2-0.3.
    Both routers are watched: a decode (row, position) beyond the bound is
    excused only where the frameworks chose other experts for that row at
    that step or an earlier one (the cache carries it on), and a prefill
    row only where they did for a token of that row or of one before it in
    the dispatch group (its capacity slots depend on those).  At most one
    decode position or prefill row in all is excused; the rest hold the
    bound."""
    jcfg, jp, tcfg, tp = _models(jx, arch, "bfloat16", seed=1)
    n_moe = tcfg.n_layers - tcfg.dense_prefix if tcfg.moe else 0
    port, ref = _routes_both(jx, monkeypatch)
    b = 2
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (b, DECODE_STEPS)).astype(np.int32)
    jl, tl, jc, tc = _decode_both(jx, jcfg, jp, tcfg, tp, toks, 16)
    jx["jax"].effects_barrier()
    routed = np.zeros((b, DECODE_STEPS), bool)
    if n_moe:
        d = _route_differs(port, ref).reshape(DECODE_STEPS, n_moe, b)
        routed = np.logical_or.accumulate(d.any(1).T, axis=1)
    err = np.array([[_rel(tl[i, t], jl[i, t]) for t in range(DECODE_STEPS)]
                    for i in range(b)])
    flipped = err > 3e-2
    assert not (flipped & ~routed).any(), err
    keep = ~flipped
    assert _rel(tl[keep], jl[keep]) <= 3e-2
    for name in tc:
        got = tc[name].float().numpy()[:, :, :DECODE_STEPS]
        want = _np(jc[name])[:, :, :DECODE_STEPS]
        assert _rel(got[:, keep], want[:, keep]) <= 1e-2, name
    port.clear()
    ref.clear()
    p = 16
    long = np.random.default_rng(3).integers(0, jcfg.vocab, (b, p)).astype(
        np.int32)
    got = tt.prefill(tcfg, tp, T(long).long()).float().numpy()
    want = _np(jx["jax"].jit(lambda p, t: jx["t"].prefill(jcfg, p, t))(
        jp, jx["jnp"].asarray(long)))
    jx["jax"].effects_barrier()
    row_routed = np.zeros(b, bool)
    if n_moe:
        d = _route_differs(port, ref).any(0).reshape(b, p).any(1)
        row_routed = np.logical_or.accumulate(d)
    rel = np.array([_rel(got[i], want[i]) for i in range(b)])
    beyond = rel > 3e-2
    assert not (beyond & ~row_routed).any(), rel
    assert flipped.sum() + beyond.sum() <= 1, (err, rel)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-30b-a3b"])
def test_mla_naive_decode_matches_reference(jx, arch):
    """decode_step(mla_absorbed=False) against the reference's (and the
    absorbed form on the GQA arch is a no-op)."""
    jnp, jt = jx["jnp"], jx["t"]
    jcfg, jp, tcfg, tp = _models(jx, arch, "float32")
    b, s = 2, 6
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (b, s)).astype(
        np.int32)
    jc = jt.init_cache(jcfg, b, 8, dtype=jnp.float32)
    tc = tt.init_cache(tcfg, b, 8, dtype=torch.float32, device="cpu")
    step = jx["jax"].jit(lambda p, c, t, l: jt.decode_step(
        jcfg, p, c, t, l, mla_absorbed=False))
    for t in range(s):
        lens = np.full((b,), t, np.int32)
        a, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(lens))
        c, tc = tt.decode_step(tcfg, tp, tc, T(toks[:, t:t + 1]).long(),
                               T(lens), mla_absorbed=False)
        np.testing.assert_allclose(c.numpy(), _np(a), rtol=1e-4, atol=1e-4)


def test_qk_norm_gqa_matches_reference(jx):
    jnp = jx["jnp"]
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8, qk_norm=True,
              rope_theta=1e6, attn_chunk_q=8, attn_chunk_k=8)
    jcfg, tcfg = jx["attn"].GqaConfig(**kw), tattn.GqaConfig(**kw)
    tp0 = tattn.gqa_init(None, tcfg, device="meta")
    assert tp0["q_norm"].shape == (8,) and tp0["k_norm"].shape == (8,)
    rng = np.random.default_rng(6)
    p = {k: (rng.standard_normal(tuple(v.shape)) * 0.4
             + (1.0 if v.dim() == 1 else 0.0)).astype(np.float32)
         for k, v in tp0.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: T(v) for k, v in p.items()}
    x = rng.standard_normal((2, 16, 32), dtype=np.float32)
    np.testing.assert_allclose(
        tattn.gqa_train(tp, tcfg, T(x)).numpy(),
        _np(jx["jax"].jit(lambda p, x: jx["attn"].gqa_train(p, jcfg, x))(
            jp, jnp.asarray(x))), rtol=1e-4, atol=1e-4)
    ck = rng.standard_normal((2, 10, 2, 8), dtype=np.float32)
    cv = rng.standard_normal((2, 10, 2, 8), dtype=np.float32)
    lens = np.array([3, 9], np.int32)
    jo, _ = jx["jax"].jit(lambda *a: jx["attn"].gqa_decode(a[0], jcfg,
                                                            *a[1:]))(
        jp, jnp.asarray(x[:, :1]), {"k": jnp.asarray(ck),
                                    "v": jnp.asarray(cv)}, jnp.asarray(lens))
    to, _ = tattn.gqa_decode(tp, tcfg, T(x[:, :1]),
                             {"k": T(ck.copy()), "v": T(cv.copy())}, T(lens))
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-5, atol=1e-5)
    # Without the norm the outputs differ: the test sees it.
    off = dataclasses.replace(tcfg, qk_norm=False)
    to2, _ = tattn.gqa_decode(tp, off, T(x[:, :1]),
                              {"k": T(ck.copy()), "v": T(cv.copy())}, T(lens))
    assert not torch.allclose(to2, to, atol=1e-3)


def test_minicpm_tied_head_and_scaling(jx):
    cfg = dataclasses.replace(minicpm_2b.SMOKE_CONFIG, attn_chunk_q=8,
                              attn_chunk_k=8)
    jcfg = jx["mods"]["minicpm-2b"].SMOKE_CONFIG
    assert cfg.residual_scale == jcfg.residual_scale == 1.4 / 2 ** 0.5
    assert cfg.logit_scale == jcfg.logit_scale == 32 / 64
    assert minicpm_2b.CONFIG.logit_scale == 256 / 2304
    assert minicpm_2b.VOCAB_PADDED == tbase.pad_to(122753, 256) == 122880
    p = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "lm_head" not in p
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    x, _ = tt.forward(cfg, p, toks)
    torch.testing.assert_close(tt.logits_from_hidden(cfg, p, x),
                               (x @ p["embed"].T) * cfg.logit_scale)
    # The knobs act: each of them changes the hidden state.
    for kw in ({"scale_emb": 1.0}, {"scale_depth": 0.0}):
        other, _ = tt.forward(dataclasses.replace(cfg, **kw), p, toks)
        assert not torch.allclose(other, x, atol=1e-3), kw
    e = tt._embed(cfg, p, toks)
    torch.testing.assert_close(e, p["embed"][toks] * 12.0)


def _fields_equal(ours, theirs, path=()):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name == "dtype":
            assert str(a).split(".")[-1] == np.dtype(b).name, path
        elif dataclasses.is_dataclass(a):
            _fields_equal(a, b, path + (f.name,))
        else:
            assert a == b, path + (f.name,)
    left = {f.name for f in dataclasses.fields(theirs)} - {
        f.name for f in dataclasses.fields(ours)}
    assert left <= TPU_ONLY, (path, left)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_and_cells_match_reference(jx, arch):
    ours, theirs = ARCHS[arch], jx["mods"][arch]
    for a, b in ((ours.CONFIG, theirs.CONFIG),
                 (ours.SMOKE_CONFIG, theirs.SMOKE_CONFIG)):
        _fields_equal(a, b)
    assert ours.SPEC.source == theirs.SPEC.source
    assert ours.SPEC.family == theirs.SPEC.family == "lm"
    assert tbase.get(arch) is ours.SPEC
    want = [(c.name, c.kind, c.meta) for c in theirs.SPEC.shapes]
    assert [(c.name, c.kind, c.meta) for c in ours.SPEC.shapes] == want


def test_registry_matches_reference(jx):
    """The port's registry holds every arch of the reference's (the LM,
    recsys, GNN and MCGI families), each in the reference's family with
    its cells' (name, kind, meta) and its source; the MCGI datasets'
    config and ``-smoke`` variant equal the reference's field for
    field."""
    ours, theirs = tbase.all_archs(), jx["base"].all_archs()
    assert set(ours) == set(theirs)
    assert {s.family for s in ours.values()} == {"lm", "recsys", "gnn",
                                                 "mcgi"}
    for arch, spec in ours.items():
        ref = theirs[arch]
        assert (spec.family, spec.source) == (ref.family, ref.source), arch
        assert [(c.name, c.kind, c.meta) for c in spec.shapes] == [
            (c.name, c.kind, c.meta) for c in ref.shapes], arch
        if spec.family != "mcgi":
            continue
        for a, b in ((spec.config, ref.config),
                     (spec.smoke_config, ref.smoke_config)):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), arch


@pytest.mark.parametrize("arch", list(ARCHS))
def test_full_width_parameter_counts(jx, arch):
    jax = jx["jax"]
    cfg = ARCHS[arch].CONFIG
    ref = jax.eval_shape(lambda k: jx["t"].init_lm(
        jx["mods"][arch].CONFIG, k), jax.random.PRNGKey(0))
    ref_total = sum(int(np.prod(leaf.shape))
                    for leaf in jax.tree.leaves(ref))
    assert cfg.n_params() == ref_total == FULL_PARAMS[arch]
    port = tt.init_lm(cfg, None, device="meta")
    assert len(port["layers"]) == cfg.n_layers
    assert ("lm_head" in port) == ("lm_head" in ref)
    kd = cfg.dense_prefix

    def walk(ref_tree, ours, n, path):
        if isinstance(ref_tree, dict):
            assert set(ref_tree) == set(ours), path
            for k in ref_tree:
                walk(ref_tree[k], ours[k], n, path + (k,))
        else:
            assert ref_tree.shape == (n,) + tuple(ours.shape), path

    for i, layer in enumerate(port["layers"]):
        group = "dense_layers" if i < kd else "layers"
        walk(ref[group], layer, kd if i < kd else cfg.n_layers - kd,
             (group, i))
    if arch in ACTIVE_PARAMS:
        assert cfg.n_active_params() == ACTIVE_PARAMS[arch]
        assert cfg.n_active_params() == jx["mods"][arch].CONFIG.\
            n_active_params()
    else:
        assert cfg.n_active_params() == cfg.n_params()


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_dsv2_smoke_decode_on_card_matches_cpu(card):
    """deepseek-v2-lite's smoke config in bfloat16 (MLA absorbed, MoE with
    the router's top-k on the ``topk`` kernel): 12 decode steps on the
    card against the CPU within the bfloat16 bound, the router's kernel
    launched once a MoE layer a step."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(deepseek_v2_lite_16b.SMOKE_CONFIG,
                              dtype=torch.bfloat16)
    cpu = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.float32)
    on_card = _to(cpu, card)
    toks = torch.randint(0, cfg.vocab, (4, DECODE_STEPS),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    ops.reset_launch_counts()
    for dev, params in (("cpu", cpu), (card, on_card)):
        cache = tt.init_cache(cfg, 4, 16, device=dev)
        logits = []
        for t in range(DECODE_STEPS):
            lens = torch.full((4,), t, dtype=torch.int32, device=dev)
            lg, cache = tt.decode_step(cfg, params, cache,
                                       toks[:, t:t + 1].to(dev), lens)
            logits.append(lg.float().cpu())
        out[str(dev)] = torch.stack(logits, 1)
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert ops.launch_counts()["topk"] == n_moe * DECODE_STEPS
    assert _rel(out[str(card)].numpy(), out["cpu"].numpy()) <= 3e-2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
