"""The port's Multi-head Latent Attention (``models/attention.py``, MLA
part) against the reference's on the CPU, on the same numpy inputs.

* ``mla_decode`` in its absorbed and naive forms, each against the
  reference's same form, float32 within 1e-4, one step against a filled
  latent cache at ragged kv_len (0, a middle one, S - 1 and S: the
  reference writes nothing at S, the port skips the write), the cache
  written in place.
* The port's absorbed form against its naive form, as the reference's
  ``test_mla_decode_absorbed_equals_naive`` holds its own (1e-5), over a
  few steps of a growing cache.
* ``mla_train`` against the reference (float32, 1e-4) and against the
  port's own decode path.
* The latent cache's layout and bytes after a write: (r + dr) values a
  token, only row kv_len[b] of each sequence changed, equal to the
  reference's cache.
* In bfloat16 the absorbed and naive forms stay within 2e-2 relative L2
  of each other (the figure ``chip_smoke.py``'s [lm-dsv2-serve] gate is
  set from).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import attention as tattn  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
KW = dict(d_model=64, n_heads=4, kv_lora_rank=32, qk_nope_dim=16,
          qk_rope_dim=8, v_head_dim=16, rope_theta=10000.0,
          attn_chunk_q=8, attn_chunk_k=8)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    return dict(jax=jax, jnp=jnp, attn=jattn)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _params(rng, cfg):
    h, r = cfg.n_heads, cfg.kv_lora_rank
    shapes = {"wq": (cfg.d_model, h * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
              "w_dkv": (cfg.d_model, r + cfg.qk_rope_dim),
              "kv_norm": (r,),
              "w_uk": (r, h * cfg.qk_nope_dim),
              "w_uv": (r, h * cfg.v_head_dim),
              "wo": (h * cfg.v_head_dim, cfg.d_model)}
    p = {k: (rng.standard_normal(s) * (s[0] ** -0.5 if len(s) == 2 else 0.3)
             + (1.0 if len(s) == 1 else 0.0)).astype(np.float32)
         for k, s in shapes.items()}
    return p


def _setup(jx, seed, b=5, s=12):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = jx["attn"].MlaConfig(**KW), tattn.MlaConfig(**KW)
    p = _params(rng, tcfg)
    x = rng.standard_normal((b, 1, KW["d_model"]), dtype=np.float32)
    c_kv = rng.standard_normal((b, s, KW["kv_lora_rank"]), dtype=np.float32)
    k_rope = rng.standard_normal((b, s, KW["qk_rope_dim"]), dtype=np.float32)
    lens = np.array([0, 5, s - 1, s, 3][:b], np.int32)
    return jcfg, tcfg, p, x, c_kv, k_rope, lens


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_decode_matches_reference(jx, absorbed):
    jnp = jx["jnp"]
    jcfg, tcfg, p, x, c_kv, k_rope, lens = _setup(jx, 1)
    jo, jc = jx["attn"].mla_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope)},
        jnp.asarray(lens), absorbed=absorbed)
    cache = {"c_kv": T(c_kv.copy()), "k_rope": T(k_rope.copy())}
    to, tc = tattn.mla_decode({k: T(v) for k, v in p.items()}, tcfg, T(x),
                              cache, T(lens), absorbed=absorbed)
    assert tc is cache                           # written in place
    assert to.shape == (5, 1, KW["d_model"]) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-4, atol=1e-4)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   rtol=1e-5, atol=1e-5)


def test_mla_absorbed_equals_naive_in_the_port():
    cfg = tattn.MlaConfig(**KW)
    g = torch.Generator().manual_seed(0)
    p = tattn.mla_init(g, cfg, device="cpu")
    b, s = 3, 8
    caches = [tattn.mla_init_cache(cfg, b, s, dtype=torch.float32,
                                   device="cpu") for _ in range(2)]
    for t in range(6):
        x = torch.randn((b, 1, KW["d_model"]), generator=g)
        lens = torch.full((b,), t, dtype=torch.int32)
        la, _ = tattn.mla_decode(p, cfg, x, caches[0], lens, absorbed=True)
        ln, _ = tattn.mla_decode(p, cfg, x, caches[1], lens, absorbed=False)
        torch.testing.assert_close(la, ln, rtol=1e-5, atol=1e-5)
    for name in ("c_kv", "k_rope"):
        assert torch.equal(caches[0][name], caches[1][name])


def test_mla_train_matches_reference_and_decode(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(2)
    jcfg, tcfg = jx["attn"].MlaConfig(**KW), tattn.MlaConfig(**KW)
    p = _params(rng, tcfg)
    x = rng.standard_normal((2, 16, KW["d_model"]), dtype=np.float32)
    want = jx["attn"].mla_train({k: jnp.asarray(v) for k, v in p.items()},
                                jcfg, jnp.asarray(x))
    tp = {k: T(v) for k, v in p.items()}
    got = tattn.mla_train(tp, tcfg, T(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    cache = tattn.mla_init_cache(tcfg, 2, 16, dtype=torch.float32,
                                 device="cpu")
    steps = [tattn.mla_decode(tp, tcfg, T(x[:, t:t + 1]), cache,
                              torch.full((2,), t, dtype=torch.int32))[0]
             for t in range(16)]
    torch.testing.assert_close(torch.cat(steps, 1), got, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_latent_cache_bytes_after_a_write(jx, dtype):
    jnp = jx["jnp"]
    jcfg, tcfg, p, x, c_kv, k_rope, lens = _setup(jx, 3)
    b, s, r = c_kv.shape
    dr = k_rope.shape[-1]
    cache = tattn.mla_init_cache(tcfg, b, s, dtype=dtype, device="cpu")
    assert cache["c_kv"].shape == (b, s, r)
    assert cache["k_rope"].shape == (b, s, dr)
    per_token = sum(c[0, 0].numel() * c.element_size()
                    for c in cache.values())
    assert per_token == (r + dr) * (2 if dtype == torch.bfloat16 else 4)
    cache["c_kv"].copy_(T(c_kv))
    cache["k_rope"].copy_(T(k_rope))
    before = {k: v.clone() for k, v in cache.items()}
    tattn.mla_decode({k: T(v) for k, v in p.items()}, tcfg, T(x), cache,
                     T(lens))
    jdt = getattr(jnp, str(dtype).split(".")[-1])
    _, jc = jx["attn"].mla_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        {"c_kv": jnp.asarray(c_kv).astype(jdt),
         "k_rope": jnp.asarray(k_rope).astype(jdt)}, jnp.asarray(lens))
    for name in ("c_kv", "k_rope"):
        changed = (cache[name] != before[name]).any(-1)       # (B, S)
        want = np.zeros((b, s), bool)
        for i, n in enumerate(lens):
            if n < s:
                want[i, n] = True
        assert np.array_equal(changed.numpy(), want), name
        got = cache[name].float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, _np(jc[name]), rtol=1e-5,
                                       atol=1e-5)
        else:   # one bfloat16 rounding of values that agree to 1e-5
            np.testing.assert_allclose(got, _np(jc[name]), rtol=8e-3,
                                       atol=1e-5)


def test_mla_bf16_absorbed_against_naive():
    cfg = tattn.MlaConfig(**KW)
    g = torch.Generator().manual_seed(4)
    p = {k: v.bfloat16() for k, v in
         tattn.mla_init(g, cfg, device="cpu").items()}
    b, s = 4, 24
    caches = [tattn.mla_init_cache(cfg, b, s, device="cpu")
              for _ in range(2)]
    outs = [[], []]
    for t in range(s):
        x = torch.randn((b, 1, KW["d_model"]), generator=g).bfloat16()
        lens = torch.full((b,), t, dtype=torch.int32)
        for i, absorbed in enumerate((True, False)):
            outs[i].append(tattn.mla_decode(p, cfg, x, caches[i], lens,
                                            absorbed=absorbed)[0].float())
    a, n = torch.cat(outs[0], 1), torch.cat(outs[1], 1)
    assert _rel(a.numpy(), n.numpy()) <= 2e-2
