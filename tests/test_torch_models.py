"""The port's dense LM (``models/`` and the qwen2-7b config) against the
reference on the same parameters and tokens.

* Building blocks (``rms_norm``, ``apply_rope``, ``swiglu``,
  ``blockwise_attention``) and ``gqa_decode`` against the reference's, in
  float32, within 1e-5.
* ``decode_step`` / ``forward`` / ``prefill`` on ``SMOKE_CONFIG`` in float32
  with the reference's ``init_lm`` parameters carried across by
  ``lm_params_from_reference``: logits and caches within 1e-4 over 16
  decode steps, the reference's own decode-vs-forward tolerance
  (``tests/test_models.py``).  In bfloat16 the two frameworks round at
  other places (fused matmul epilogues, ``silu``), so logits are held to a
  relative L2 error of 3e-2 and caches to 1e-2: one bfloat16 ulp is up to
  7.8e-3 relative, and the measured errors are 8.8e-3 (decode logits),
  1.2e-2 (prefill logits) and 4.3e-3 (caches).
* The port's own decode-equals-forward, and at full width a shape-only
  check on the meta device: the same parameter shapes as the reference's
  ``jax.eval_shape(init_lm)``, 7,615,616,512 parameters.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import qwen2_7b as tq  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.blockwise import blockwise_attention  # noqa: E402
from repro_torch.models.convert import lm_params_from_reference  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
QWEN2_7B_PARAMS = 7_615_616_512


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import qwen2_7b as jq
    from repro.models import attention as jattn
    from repro.models import layers as jlayers
    from repro.models import transformer as jt
    from repro.models.blockwise import blockwise_attention as jblock
    return dict(jax=jax, jnp=jnp, jq=jq, attn=jattn, layers=jlayers, t=jt,
                block=jblock)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _models(jx, dtype: str, seed: int = 0):
    """The reference's smoke model and the port's copy of its parameters."""
    jnp = jx["jnp"]
    jcfg = dataclasses.replace(jx["jq"].SMOKE_CONFIG,
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tq.SMOKE_CONFIG, dtype=getattr(torch, dtype))
    jp = jx["t"].init_lm(jcfg, jx["jax"].random.PRNGKey(seed))
    tp = lm_params_from_reference(jx["jax"].tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _decode_both(jx, jcfg, jp, tcfg, tp, toks, max_len):
    """Feed ``toks`` one position at a time through both decode steps;
    returns the (B, S, V) logits of each and their final caches."""
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
    return np.stack(jl, 1), np.stack(tl, 1), jc, tc


# ------------------------------------------------------------ blocks


def test_layers_match_reference(jx):
    jnp, jl = jx["jnp"], jx["layers"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32) * 3
    gamma = rng.standard_normal(16, dtype=np.float32)
    np.testing.assert_allclose(tlayers.rms_norm(T(x), T(gamma)).numpy(),
                               _np(jl.rms_norm(jnp.asarray(x),
                                               jnp.asarray(gamma))),
                               rtol=1e-5, atol=1e-5)
    pos = np.array([[0, 1, 2, 700, 524287]], np.int32)
    for theta in (10000.0, 1_000_000.0):
        np.testing.assert_allclose(
            tlayers.apply_rope(T(x), T(pos), theta).numpy(),
            _np(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tlayers.rope_freqs(16, theta).numpy(),
                                   _np(jl.rope_freqs(16, theta)), rtol=1e-6)
    w = {k: rng.standard_normal(s, dtype=np.float32) * 0.2 for k, s in
         (("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
    np.testing.assert_allclose(
        tlayers.swiglu({k: T(v) for k, v in w.items()}, T(x)).numpy(),
        _np(jl.swiglu({k: jnp.asarray(v) for k, v in w.items()},
                      jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_rms_norm_and_rope_round_as_the_reference_in_bf16(jx):
    """rms_norm casts to bfloat16 before gamma; apply_rope rotates in
    float32 and casts back: both within one bfloat16 ulp of the
    reference."""
    jnp, jl = jx["jnp"], jx["layers"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32), dtype=np.float32)
    xb = T(x).bfloat16()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    gamma = rng.standard_normal(32, dtype=np.float32)
    got = tlayers.rms_norm(xb, T(gamma).bfloat16())
    want = jl.rms_norm(xj, jnp.asarray(gamma).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=8e-3,
                               atol=1e-6)
    pos = np.arange(7, dtype=np.int32)[None] * 1000
    got = tlayers.apply_rope(xb, T(pos), 1_000_000.0)
    want = jl.apply_rope(xj, jnp.asarray(pos), 1_000_000.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=8e-3,
                               atol=1e-2)


@pytest.mark.parametrize("shape,dv,chunks", [
    ((2, 32, 2, 3, 16), 16, (8, 8)), ((1, 64, 2, 2, 8), 12, (16, 8)),
    ((2, 48, 1, 7, 16), 16, (48, 16))])
def test_blockwise_matches_reference(jx, shape, dv, chunks):
    jnp = jx["jnp"]
    rng = np.random.default_rng(sum(shape))
    b, s, hkv, _, d = shape
    q = rng.standard_normal(shape, dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, dv), dtype=np.float32)
    got = blockwise_attention(T(q), T(k), T(v), chunk_q=chunks[0],
                              chunk_k=chunks[1])
    want = jx["block"](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       chunk_q=chunks[0], chunk_k=chunks[1])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    # Against the dense causal softmax.
    logits = np.einsum("bshgd,bthd->bhgst", q, k) * d ** -0.5
    logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    dense = np.einsum("bhgst,bthd->bshgd", w / w.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.numpy(), dense, rtol=2e-5, atol=2e-5)


def test_blockwise_rejects_ragged_chunks():
    q = torch.zeros(1, 10, 1, 1, 4)
    with pytest.raises(ValueError):
        blockwise_attention(q, torch.zeros(1, 10, 1, 4),
                            torch.zeros(1, 10, 1, 4), chunk_q=4, chunk_k=4)


def test_gqa_decode_matches_reference(jx):
    """One step against a filled cache: ragged kv_len, one row whose cache
    is full (kv_len = S: the reference writes nothing, the port skips the
    write) and one at position 0."""
    jnp = jx["jnp"]
    cfg_j = jx["attn"].GqaConfig(d_model=32, n_heads=6, n_kv_heads=2,
                                 d_head=8, qkv_bias=True,
                                 rope_theta=1e6)
    cfg_t = tattn.GqaConfig(d_model=32, n_heads=6, n_kv_heads=2, d_head=8,
                            qkv_bias=True, rope_theta=1e6)
    pj = jx["attn"].gqa_init(jx["jax"].random.PRNGKey(3), cfg_j)
    rng = np.random.default_rng(3)
    pj = {k: jnp.asarray(rng.standard_normal(np.shape(v), dtype=np.float32)
                         * 0.3) for k, v in pj.items()}
    pt = {k: T(np.array(v, np.float32)) for k, v in pj.items()}
    b, s = 4, 20
    x = rng.standard_normal((b, 1, 32), dtype=np.float32)
    ck = rng.standard_normal((b, s, 2, 8), dtype=np.float32)
    cv = rng.standard_normal((b, s, 2, 8), dtype=np.float32)
    lens = np.array([0, 7, 19, 20], np.int32)
    jo, jc = jx["attn"].gqa_decode(pj, cfg_j, jnp.asarray(x),
                                   {"k": jnp.asarray(ck),
                                    "v": jnp.asarray(cv)}, jnp.asarray(lens))
    cache = {"k": T(ck.copy()), "v": T(cv.copy())}
    to, tc = tattn.gqa_decode(pt, cfg_t, T(x), cache, T(lens))
    assert tc is cache                          # written in place
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   rtol=1e-5, atol=1e-5)
    assert np.array_equal(tc["k"][3].numpy(), ck[3])   # full row untouched


def test_write_at_skips_rows_past_the_cache():
    buf = torch.zeros(3, 4, 2)
    tattn.write_at(buf, torch.ones(3, 2), torch.tensor([0, 4, 9]))
    assert buf[0, 0].eq(1).all() and buf[1:].eq(0).all()


# ------------------------------------------------------------ the model


def test_decode_step_forward_prefill_match_reference_f32(jx):
    jnp, jt = jx["jnp"], jx["t"]
    jcfg, jp, tcfg, tp = _models(jx, "float32")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16)).astype(
        np.int32)
    jl, tl, jc, tc = _decode_both(jx, jcfg, jp, tcfg, tp, toks, 32)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   rtol=1e-4, atol=1e-4)
    x, _ = jt.forward(jcfg, jp, jnp.asarray(toks))
    jf = jt.logits_from_hidden(jcfg, jp, x, None)
    tx, aux = tt.forward(tcfg, tp, T(toks).long())
    assert float(aux) == 0.0
    np.testing.assert_allclose(tx.numpy(), _np(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tt.logits_from_hidden(tcfg, tp, tx).numpy(),
                               _np(jf), rtol=1e-4, atol=1e-4)
    long = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 48)).astype(
        np.int32)
    np.testing.assert_allclose(
        tt.prefill(tcfg, tp, T(long).long()).numpy(),
        _np(jt.prefill(jcfg, jp, jnp.asarray(long))), rtol=1e-4, atol=1e-4)


def test_decode_step_matches_reference_bf16(jx):
    jcfg, jp, tcfg, tp = _models(jx, "bfloat16")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 16)).astype(
        np.int32)
    jl, tl, jc, tc = _decode_both(jx, jcfg, jp, tcfg, tp, toks, 24)
    assert _rel(tl, jl) <= 3e-2
    for name in ("k", "v"):
        assert _rel(tc[name].float().numpy(), jc[name]) <= 1e-2
    assert _rel(tt.prefill(tcfg, tp, T(toks).long()).float().numpy(),
                jx["t"].prefill(jcfg, jp, jx["jnp"].asarray(toks))) <= 3e-2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_port_decode_equals_forward(dtype, tol):
    """Without the reference: 24 decode steps give the forward pass's
    logits at every position (float32 within 1e-4, bfloat16 within 3e-2
    relative L2), and prefill gives the last of them."""
    cfg = dataclasses.replace(tq.SMOKE_CONFIG, dtype=getattr(torch, dtype),
                              attn_chunk_q=8, attn_chunk_k=8)
    params = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (3, 24),
                         generator=torch.Generator().manual_seed(1))
    cache = tt.init_cache(cfg, 3, 40, dtype=cfg.dtype, device="cpu")
    outs = []
    for t in range(24):
        lg, cache = tt.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                   torch.full((3,), t, dtype=torch.int32))
        outs.append(lg.float())
    dec = torch.stack(outs, 1)
    x, _ = tt.forward(cfg, params, toks)
    full = tt.logits_from_hidden(cfg, params, x).float()
    pre = tt.prefill(cfg, params, toks).float()
    if dtype == "float32":
        torch.testing.assert_close(dec, full, rtol=tol, atol=tol)
        torch.testing.assert_close(pre, full[:, -1], rtol=tol, atol=tol)
    else:
        assert _rel(dec.numpy(), full.numpy()) <= tol
        assert _rel(pre.numpy(), dec[:, -1].numpy()) <= tol


def test_full_width_shapes_match_reference(jx):
    """qwen2-7b at full width, shapes only: the port's per-layer parameters
    are the reference's stacked ones with the layer axis taken out."""
    jax = jx["jax"]
    ref_shapes = jax.eval_shape(
        lambda k: jx["t"].init_lm(jx["jq"].CONFIG, k), jax.random.PRNGKey(0))
    port = tt.init_lm(tq.CONFIG, None, device="meta")
    assert port["embed"].dtype == torch.bfloat16
    n = tq.CONFIG.n_layers
    assert len(port["layers"]) == n
    for key in ("embed", "ln_final", "lm_head"):
        assert tuple(port[key].shape) == ref_shapes[key].shape

    def walk(ref, ours, path):
        if isinstance(ref, dict):
            assert set(ref) == set(ours), path
            for k in ref:
                walk(ref[k], ours[k], path + (k,))
        else:
            assert ref.shape == (n,) + tuple(ours.shape), path

    for layer in port["layers"]:
        walk(ref_shapes["layers"], layer, ())
    ref_total = sum(int(np.prod(leaf.shape))
                    for leaf in jax.tree.leaves(ref_shapes))
    assert ref_total == tq.CONFIG.n_params() == QWEN2_7B_PARAMS


def test_unported_configs_raise():
    """Every attention the reference has is ported; an unknown one raises
    ValueError from each entry point, before any work."""
    cfg = dataclasses.replace(tq.SMOKE_CONFIG, attention="linear")
    with pytest.raises(ValueError, match="unknown attention 'linear'"):
        tt.init_lm(cfg, None, device="meta")
    with pytest.raises(ValueError):
        tt.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError):
        tt.decode_step(cfg, {}, {}, torch.zeros(1, 1).long(),
                       torch.zeros(1).int())
    with pytest.raises(ValueError):
        tt.prefill(cfg, {}, torch.zeros(1, 4).long())


def test_config_registry():
    spec = tbase.get("qwen2-7b")
    assert spec.config is tq.CONFIG and spec.smoke_config is tq.SMOKE_CONFIG
    assert spec.cell("decode_32k").meta == {"seq": 32768, "batch": 128}
    assert spec.cell("long_500k").meta == {"seq": 524288, "batch": 1}
    archs = tbase.all_archs()
    lm = {"qwen2-7b", "deepseek-coder-33b", "minicpm-2b",
          "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"}
    mcgi = {"mcgi-sift1m", "mcgi-glove100", "mcgi-gist1m", "mcgi-sift1b",
            "mcgi-t2i1b"}
    recsys = {"dlrm-mlperf", "deepfm", "mind", "bert4rec"}
    assert set(archs) == lm | mcgi | recsys | {"gat-cora"}
    for name, a in archs.items():
        family = ("lm" if name in lm else "mcgi" if name in mcgi
                  else "recsys" if name in recsys else "gnn")
        assert a.family == family
        if family in ("lm", "mcgi"):
            assert a.smoke_config.name.endswith("-smoke")
            assert a.smoke_config.name != a.config.name
        else:
            assert a.smoke_config != a.config
    sift = archs["mcgi-sift1m"]
    assert sift.smoke_config.n == 4096 and sift.smoke_config.d == 64
    assert [(c.name, c.kind, c.meta) for c in sift.shapes] == [
        ("serve", tbase.MCGI_SEARCH, {"queries": 4096, "k": 10})]
    assert tbase.get("bert4rec").shapes == tbase.RECSYS_SHAPES
    assert [c.name for c in tbase.get("gat-cora").shapes] == [
        "full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
    with pytest.raises(KeyError):
        tbase.get("bert4rec-xl")
    with pytest.raises(ValueError):
        tbase.register(spec)


def test_config_matches_reference(jx):
    for ours, theirs in ((tq.CONFIG, jx["jq"].CONFIG),
                         (tq.SMOKE_CONFIG, jx["jq"].SMOKE_CONFIG)):
        for f in dataclasses.fields(ours):
            if f.name != "dtype":
                assert getattr(ours, f.name) == getattr(theirs, f.name), f
        assert str(ours.dtype).split(".")[-1] == np.dtype(theirs.dtype).name
    want = [(c.name, c.kind, c.meta) for c in jx["jq"].SPEC.shapes]
    assert [(c.name, c.kind, c.meta) for c in tq.SPEC.shapes] == want
