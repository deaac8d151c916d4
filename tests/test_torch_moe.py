"""The port's MoE layer (``models/moe.py``) against the reference's on the
CPU, on the same numpy inputs.

* On integer-valued tokens and router weights (exact logits), the routed
  expert ids, each group's ``dest`` / ``keep`` (the capacity drop set) and
  expert buffers are bit-identical to the reference's at capacity factors
  1.0 and 0.5, with ``no_drop``, and at 1 / 2 / 3 groups (3 halves to 1
  where it does not divide the tokens).  The reference's groups are
  formed by its own ``_dispatch_group`` under ``vmap``; the port's are
  read by wrapping its ``_dispatch_group`` during ``moe_apply``.
* A router of zeros sends every token to experts 0..k-1 in both packages
  (ties to the lower id).
* On float data ``moe_apply`` is within rtol 1e-5 / atol 1e-5 of the
  reference for both smoke MoE configs (deepseek-v2-lite's shared experts
  included) and ``load_balance_loss`` is equal within float32 rounding;
  expert ids are equal wherever the k-th and (k+1)-th router
  probabilities differ by more than 1e-5 relative, and the test counts
  the near-ties it excludes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import deepseek_v2_lite_16b as tdsv2  # noqa: E402
from repro_torch.configs import qwen3_moe_30b_a3b as tqwen3  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
NEAR_TIE_RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    return dict(jax=jax, jnp=jnp, moe=jmoe)


def _np(x):
    return np.asarray(x)


def _params(rng, d, e, f, n_shared=0, fs=0, integer_router=False):
    p = {"router": (rng.integers(-2, 3, (d, e)) if integer_router
                    else rng.standard_normal((d, e)) * 0.3),
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    if n_shared:
        p["shared"] = {"w_gate": rng.standard_normal((d, fs)) * d ** -0.5,
                       "w_up": rng.standard_normal((d, fs)) * d ** -0.5,
                       "w_down": rng.standard_normal((fs, d)) * fs ** -0.5}
    return _tree(p, lambda a: np.asarray(a, np.float32))


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _both(jx, p):
    return _tree(p, jx["jnp"].asarray), _tree(p, T)


def _cfgs(jx, **kw):
    return jx["moe"].MoeConfig(**kw), tmoe.MoeConfig(**kw)


def _port_groups(monkeypatch):
    """Wrap the port's _dispatch_group: each call's (buf, dest, keep)."""
    seen = []
    real = tmoe._dispatch_group

    def spy(x_g, eid_g, cap, n_experts):
        out = real(x_g, eid_g, cap, n_experts)
        seen.append((cap,) + tuple(o.numpy().copy() for o in out))
        return out
    monkeypatch.setattr(tmoe, "_dispatch_group", spy)
    return seen


def _ref_groups(jx, jcfg, x, eid, n_groups, no_drop):
    """The reference's groups: its halving rule and capacity formula
    (``moe_apply``), its ``_dispatch_group`` under ``vmap``."""
    jax, jnp = jx["jax"], jx["jnp"]
    t, d = x.shape
    while t % n_groups:
        n_groups //= 2
    tg = t // n_groups
    cap = tg if no_drop else max(
        int(jcfg.capacity_factor * tg * jcfg.top_k / jcfg.n_experts), 1)
    buf, dest, keep = jax.vmap(lambda xx, ee: jx["moe"]._dispatch_group(
        xx, ee, cap, jcfg.n_experts))(
        jnp.asarray(x.reshape(n_groups, tg, d)),
        jnp.asarray(eid.reshape(n_groups, tg, -1)))
    return n_groups, cap, _np(buf), _np(dest), _np(keep)


@pytest.mark.parametrize("b,s", [(2, 10), (3, 8)])
@pytest.mark.parametrize("cf,no_drop,n_groups", [
    (1.0, False, 1), (0.5, False, 1), (1.0, True, 1), (1.0, False, 2),
    (0.5, False, 3), (1.0, True, 3)])
def test_routing_and_drops_bit_identical_on_integer_data(
        jx, monkeypatch, b, s, cf, no_drop, n_groups):
    d, e, k, f = 16, 8, 3, 12
    rng = np.random.default_rng(b * 100 + s + n_groups)
    p = _params(rng, d, e, f, integer_router=True)
    x = rng.integers(-3, 4, (b, s, d)).astype(np.float32)
    jcfg, tcfg = _cfgs(jx, d_model=d, n_experts=e, top_k=k, d_expert=f,
                       capacity_factor=cf)
    jp, tp = _both(jx, p)
    x_flat = x.reshape(b * s, d)
    je, _, _ = jx["moe"]._route(jp, jcfg, jx["jnp"].asarray(x_flat))
    te, _, _ = tmoe._route(tp, tcfg, T(x_flat))
    assert te.dtype == torch.int32
    assert np.array_equal(te.numpy(), _np(je))

    seen = _port_groups(monkeypatch)
    tout, _ = tmoe.moe_apply(tp, tcfg, T(x), no_drop=no_drop,
                             n_groups=n_groups)
    ng, cap, jbuf, jdest, jkeep = _ref_groups(jx, jcfg, x_flat, _np(je),
                                              n_groups, no_drop)
    assert len(seen) == ng and all(g[0] == cap for g in seen)
    for i, (_, buf, dest, keep) in enumerate(seen):
        assert dest.dtype == np.int32
        assert np.array_equal(dest, jdest[i]), i
        assert np.array_equal(keep, jkeep[i]), i
        assert np.array_equal(buf, jbuf[i]), i
    dropped = int((~jkeep).sum())
    if no_drop:
        assert dropped == 0
    elif cf == 0.5:
        assert dropped > 0          # the drop set is exercised
    jout, _ = jx["moe"].moe_apply(jp, jcfg, jx["jnp"].asarray(x),
                                  no_drop=no_drop, n_groups=n_groups)
    np.testing.assert_allclose(tout.numpy(), _np(jout), rtol=1e-5,
                               atol=1e-5)


def test_zero_router_sends_every_token_to_the_first_k_experts(jx):
    d, e, k, f = 16, 8, 3, 12
    rng = np.random.default_rng(5)
    p = _params(rng, d, e, f)
    p["router"] = np.zeros_like(p["router"])
    jcfg, tcfg = _cfgs(jx, d_model=d, n_experts=e, top_k=k, d_expert=f)
    jp, tp = _both(jx, p)
    x = rng.standard_normal((20, d)).astype(np.float32)
    je, jg, _ = jx["moe"]._route(jp, jcfg, jx["jnp"].asarray(x))
    te, tg, _ = tmoe._route(tp, tcfg, T(x))
    want = np.broadcast_to(np.arange(k, dtype=np.int32), (20, k))
    assert np.array_equal(_np(je), want)
    assert np.array_equal(te.numpy(), want)
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-6)


def _near_ties(probs: np.ndarray, k: int) -> np.ndarray:
    """(T,) bool: rows whose k-th and (k+1)-th probabilities lie within
    NEAR_TIE_RTOL of each other (relative)."""
    srt = -np.sort(-probs, axis=1)
    kth, nxt = srt[:, k - 1], srt[:, k]
    return (kth - nxt) <= NEAR_TIE_RTOL * kth


@pytest.mark.parametrize("spec", [tqwen3, tdsv2], ids=["qwen3-moe",
                                                       "deepseek-v2-lite"])
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_apply_matches_reference_on_float_data(jx, spec, no_drop):
    mcfg = spec.SMOKE_CONFIG.moe
    jcfg, tcfg = _cfgs(jx, **{f: getattr(mcfg, f) for f in
                              mcfg.__dataclass_fields__})
    rng = np.random.default_rng(11 + no_drop)
    p = _params(rng, mcfg.d_model, mcfg.n_experts, mcfg.d_expert,
                mcfg.n_shared, mcfg.shared_hidden * mcfg.n_shared)
    jp, tp = _both(jx, p)
    x = rng.standard_normal((4, 24, mcfg.d_model)).astype(np.float32)
    x_flat = x.reshape(-1, mcfg.d_model)
    je, jgate, jprobs = jx["moe"]._route(jp, jcfg, jx["jnp"].asarray(x_flat))
    te, tgate, tprobs = tmoe._route(tp, tcfg, T(x_flat))
    np.testing.assert_allclose(tprobs.numpy(), _np(jprobs), rtol=1e-5,
                               atol=1e-7)
    ties = _near_ties(_np(jprobs), mcfg.top_k)
    # Counted, not hidden: random float routers rarely come this close.
    assert ties.sum() <= 2, f"{ties.sum()} near-ties of {len(ties)} tokens"
    assert np.array_equal(te.numpy()[~ties], _np(je)[~ties])
    np.testing.assert_allclose(tgate.numpy()[~ties], _np(jgate)[~ties],
                               rtol=1e-5, atol=1e-6)
    jl = jx["moe"].load_balance_loss(jprobs, je, mcfg.n_experts)
    tl = tmoe.load_balance_loss(tprobs, te, mcfg.n_experts)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    tout, taux = tmoe.moe_apply(tp, tcfg, T(x), no_drop=no_drop)
    jout, jaux = jx["moe"].moe_apply(jp, jcfg, jx["jnp"].asarray(x),
                                     no_drop=no_drop)
    if not ties.any():
        np.testing.assert_allclose(tout.numpy(), _np(jout), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert tout.shape == x.shape and tout.dtype == torch.float32


def test_capacity_formula_and_halving():
    """cap = max(int(cf * tg * k / E), 1), tg under no_drop; a group count
    that does not divide T halves until it does."""
    cfg = tmoe.MoeConfig(d_model=8, n_experts=4, top_k=2, d_expert=4,
                         capacity_factor=0.25)
    p = _tree(_params(np.random.default_rng(0), 8, 4, 4), T)
    caps = []
    real = tmoe._dispatch_group
    try:
        tmoe._dispatch_group = lambda x, e, cap, n: (caps.append(
            (x.shape[0], cap)) or real(x, e, cap, n))
        tmoe.moe_apply(p, cfg, torch.randn(1, 7, 8), n_groups=4)
        tmoe.moe_apply(p, cfg, torch.randn(2, 6, 8), n_groups=3)
        tmoe.moe_apply(p, cfg, torch.randn(2, 6, 8), n_groups=3,
                       no_drop=True)
    finally:
        tmoe._dispatch_group = real
    # 7 tokens: 4 -> 2 -> 1 group, cap max(int(0.25 * 7 * 2 / 4), 1) = 1;
    # 12 tokens in 3 groups of 4: cap 1 (0.5 floors to 0); no_drop: 4.
    assert caps == [(7, 1)] + [(4, 1)] * 3 + [(4, 4)] * 3
