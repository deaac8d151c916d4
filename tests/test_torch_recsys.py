"""The port's recsys models against the reference's, on the CPU.

* ``layer_norm`` (eps 1e-6), ``mlp_init`` / ``mlp_apply``,
  ``bce_with_logits``; ``embedding_bag`` in its three modes with weights
  and masks (an all-masked bag included), ``fused_lookup``'s offsets,
  ``fused_table_init``'s law, ``_dot_interaction``'s order.
* Each of the four smoke configs (dlrm-mlperf, deepfm, mind, bert4rec):
  the reference's init carried across with ``params_from_reference``,
  numpy batches from a seed; loss, every gradient, serve and retrieval
  within 1e-5 relative.  An exact (erf) GELU in BERT4Rec breaks that
  bound; the tanh form the reference uses holds it.
* The four configs field for field, with their cells, and the full-width
  parameter shapes on the meta device.
* A ``gpu`` test runs each smoke model on the card against the CPU; the
  reference is imported in a fixture, so it runs without JAX.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
RTOL = 1e-5
ARCHS = {"dlrm-mlperf": "dlrm_mlperf", "deepfm": "deepfm", "mind": "mind",
         "bert4rec": "bert4rec"}
B, C = 32, 96          # batch rows; retrieval candidates
SLATE = 100            # serve's candidate slate (the reference's cells)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import embedding as jemb
    from repro.models import layers as jlayers
    from repro.models import recsys as jrec
    mods = {a: importlib.import_module(f"repro.configs.{m}")
            for a, m in ARCHS.items()}
    return dict(jax=jax, jnp=jnp, emb=jemb, layers=jlayers, rec=jrec,
                mods=mods, cache={})


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------- building blocks

def test_layer_norm_and_mlp_match_reference(jx):
    jnp, jl = jx["jnp"], jx["layers"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 24)).astype(np.float32)
    # Rows of tiny variance: eps 1e-6 (not torch's 1e-5) shows there.
    x[0, :3] = 1e-3 * rng.standard_normal((3, 24)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = _np(jl.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    got = tlayers.layer_norm(T(x), T(g), T(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    torch_eps = torch.nn.functional.layer_norm(T(x), (24,), T(g), T(b))
    assert np.abs(torch_eps.numpy()[0, :3] - want[0, :3]).max() > 1e-3
    # bfloat16: normalised in float32, cast back, then scaled.
    xb = T(x).bfloat16()
    got_b = tlayers.layer_norm(xb, T(g).bfloat16(), T(b).bfloat16())
    want_b = jl.layer_norm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(g, jnp.bfloat16),
                           jnp.asarray(b, jnp.bfloat16))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_b.float().numpy(), _np(want_b))

    jp = jl.mlp_init(jx["jax"].random.PRNGKey(1), (24, 16, 8, 3))
    tp = params_from_reference(jx["jax"].tree.map(np.asarray, jp),
                               device="cpu")
    assert sorted(tp) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    for fa, ja, final in ((torch.relu, jx["jax"].nn.relu, False),
                          (torch.tanh, jnp.tanh, True)):
        want = _np(jl.mlp_apply(jp, jnp.asarray(x), act=ja, final_act=final))
        got = tlayers.mlp_apply(tp, T(x), act=fa, final_act=final).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ours = tlayers.mlp_init(torch.Generator().manual_seed(0), (24, 16, 3),
                            device="cpu")
    assert [tuple(ours[k].shape) for k in ("w0", "w1", "b0", "b1")] == [
        (24, 16), (16, 3), (16,), (3,)]
    assert float(ours["b0"].abs().max()) == 0.0
    w = tlayers.mlp_init(torch.Generator().manual_seed(0), (4096, 64),
                         device="cpu")["w0"]
    assert abs(float(w.std()) - 4096 ** -0.5) < 0.02 * 4096 ** -0.5


def test_bce_with_logits_matches_reference(jx):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(257) * 8).astype(np.float32)
    x[:4] = [60.0, -60.0, 0.0, 1e-4]
    y = (rng.uniform(size=257) < 0.4).astype(np.float32)
    want = float(jx["rec"].bce_with_logits(jx["jnp"].asarray(x),
                                           jx["jnp"].asarray(y)))
    np.testing.assert_allclose(float(trec.bce_with_logits(T(x), T(y))), want,
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_matches_reference(jx, mode, weighted, masked):
    """Every mode with and without weights and a mask; with a mask, bag 0
    is all masked (mean: 0, max: -inf, as the reference gives)."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, (7, 5)).astype(np.int32)
    w = rng.uniform(0.2, 2.0, (7, 5)).astype(np.float32) if weighted else None
    m = None
    if masked:
        m = rng.uniform(size=(7, 5)) < 0.6
        m[0] = False
        m[1] = True
    want = _np(jx["emb"].embedding_bag(
        jnp.asarray(table), jnp.asarray(idx),
        None if w is None else jnp.asarray(w),
        None if m is None else jnp.asarray(m), mode=mode))
    got = temb.embedding_bag(T(table), T(idx), None if w is None else T(w),
                             None if m is None else T(m), mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if masked and mode == "max":
        assert np.isneginf(got[0]).all()
    if masked and mode == "mean":
        assert (got[0] == 0).all()
    with pytest.raises(ValueError):
        temb.embedding_bag(T(table), T(idx), mode="median")


def test_fused_table_spec_lookup_and_init(jx):
    jnp = jx["jnp"]
    vocabs = (7, 1, 300, 12)
    spec = temb.FusedTableSpec(vocabs, 4)
    ref = jx["emb"].FusedTableSpec(vocabs, 4)
    assert spec.offsets == ref.offsets == (0, 7, 8, 308)
    assert spec.total_rows == 320 and spec.padded_rows == ref.padded_rows
    assert spec.padded_rows == temb.ROW_MULTIPLE == jx["emb"].ROW_MULTIPLE
    assert temb.pad_rows(513) == jx["emb"].pad_rows(513) == 1024
    table = np.arange(spec.padded_rows * 4, dtype=np.float32).reshape(-1, 4)
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, v, 9) for v in vocabs], 1).astype(
        np.int32)
    got = temb.fused_lookup(T(table), spec, T(ids)).numpy()
    want = _np(jx["emb"].fused_lookup(jnp.asarray(table), ref,
                                      jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :, 0] // 4,
                                  ids + np.asarray(spec.offsets))
    t = temb.fused_table_init(torch.Generator().manual_seed(0),
                              temb.FusedTableSpec((100_000,), 8),
                              device="cpu")
    assert t.shape == (100_352, 8) and float(t.abs().max()) <= 0.01
    assert float(t.abs().max()) > 0.0099       # uniform in +-0.01
    assert temb.fused_table_init(None, spec, device="meta").shape == (512, 4)


def test_dot_interaction_order(jx):
    rng = np.random.default_rng(4)
    v = rng.standard_normal((3, 6, 5)).astype(np.float32)
    got = trec._dot_interaction(T(v)).numpy()
    want = _np(jx["rec"]._dot_interaction(jx["jnp"].asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pairs = [(i, j) for i in range(6) for j in range(i)]   # row-major
    assert got.shape == (3, len(pairs))
    for n, (i, j) in enumerate(pairs):
        np.testing.assert_allclose(got[:, n], (v[:, i] * v[:, j]).sum(-1),
                                   rtol=1e-5)


# ----------------------------------------------------------------- models

def _batches(arch: str, cfg, seed: int = 0) -> dict:
    """numpy batches of the arch: "train", "serve" and "retrieval"."""
    rng = np.random.default_rng(seed)
    if arch in ("dlrm-mlperf", "deepfm"):
        vocabs = (cfg.vocab_sizes if arch == "dlrm-mlperf"
                  else (cfg.vocab_per_field,) * cfg.n_fields)

        def sparse(n):
            return np.stack([rng.integers(0, v, n) for v in vocabs],
                            1).astype(np.int32)

        train = {"sparse": sparse(B),
                 "labels": (rng.uniform(size=B) < 0.4).astype(np.float32)}
        serve = {"sparse": sparse(B)}
        retr = {"sparse": sparse(1),
                "candidates": rng.integers(0, vocabs[0], C).astype(np.int32)}
        if arch == "dlrm-mlperf":
            for d, n in ((train, B), (serve, B), (retr, 1)):
                d["dense"] = rng.standard_normal((n, cfg.n_dense)).astype(
                    np.float32)
        return {"train": train, "serve": serve, "retrieval": retr}
    if arch == "mind":
        def hist(n):
            lens = rng.integers(1, cfg.hist_len + 1, n)
            lens[0] = cfg.hist_len
            return {"hist": rng.integers(0, cfg.n_items, (n, cfg.hist_len))
                    .astype(np.int32),
                    "hist_mask": np.arange(cfg.hist_len)[None] < lens[:, None]}
        train = dict(hist(B), target=rng.integers(0, cfg.n_items, B).astype(
            np.int32))
        serve = dict(hist(B), candidates=rng.integers(
            0, cfg.n_items, SLATE).astype(np.int32))
        retr = dict(hist(1), candidates=rng.integers(
            0, cfg.n_items, C).astype(np.int32))
        return {"train": train, "serve": serve, "retrieval": retr}

    s, p = cfg.seq_len, 4

    def seqs(n):
        seq = rng.integers(0, cfg.n_items, (n, s)).astype(np.int32)
        seq[:, -1] = cfg.mask_token
        mask = np.ones((n, s), bool)
        mask[1:, :rng.integers(0, s // 3)] = False     # left padding
        return {"seq": seq, "seq_mask": mask}

    train = seqs(B)
    pos = np.stack([rng.choice(s, p, replace=False) for _ in range(B)])
    train["mlm_positions"] = pos.astype(np.int32)
    labels = rng.integers(0, cfg.n_items, (B, p)).astype(np.int32)
    labels[::3, 0] = -1                                   # padded labels
    train["mlm_labels"] = labels
    np.put_along_axis(train["seq"], pos, cfg.mask_token, 1)
    serve = dict(seqs(B), candidates=rng.integers(
        0, cfg.n_items, SLATE).astype(np.int32))
    retr = dict(seqs(1), candidates=rng.integers(
        0, cfg.n_items, C).astype(np.int32))
    return {"train": train, "serve": serve, "retrieval": retr}


def _fns(mod, arch: str, cfg):
    """{"init", "loss", "serve", "retrieval"} of a models module (the
    reference's or the port's), as the reference's cells bind them."""
    name = {"dlrm-mlperf": "dlrm", "deepfm": "deepfm", "mind": "mind",
            "bert4rec": "bert4rec"}[arch]
    loss = getattr(mod, f"{name}_loss")
    retr = getattr(mod, f"{name}_retrieval")
    if arch == "dlrm-mlperf":
        serve = lambda p, b: mod.dlrm_forward(cfg, p, b["dense"],  # noqa
                                              b["sparse"])
    elif arch == "deepfm":
        serve = lambda p, b: mod.deepfm_forward(cfg, p, b["sparse"])  # noqa
    else:
        serve = lambda p, b: retr(cfg, p, b)  # noqa: E731
    return {"init": getattr(mod, f"{name}_init"),
            "loss": lambda p, b: loss(cfg, p, b)[0],
            "serve": serve, "retrieval": lambda p, b: retr(cfg, p, b)}


def _reference(jx, arch: str):
    """The reference's smoke params (numpy), and its loss, gradients,
    serve and retrieval on :func:`_batches` (computed once a module)."""
    if arch in jx["cache"]:
        return jx["cache"][arch]
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = jx["mods"][arch].SMOKE_CONFIG
    fns = _fns(jx["rec"], arch, cfg)
    params = jax.jit(lambda k: fns["init"](k, cfg))(jax.random.PRNGKey(0))
    bt = _batches(arch, cfg)
    jb = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in bt.items()}
    loss, grads = jax.jit(jax.value_and_grad(fns["loss"]))(params,
                                                           jb["train"])
    out = {"params": jax.tree.map(np.asarray, params), "batches": bt,
           "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
           "serve": _np(jax.jit(fns["serve"])(params, jb["serve"])),
           "retrieval": _np(jax.jit(fns["retrieval"])(params,
                                                      jb["retrieval"]))}
    jx["cache"][arch] = out
    return out


def _port(arch: str, params, batches, device="cpu"):
    """The port's loss, gradients (the params' tree), serve and
    retrieval."""
    cfg = tbase.get(arch).smoke_config
    fns = _fns(trec, arch, cfg)
    tb = {k: {n: T(a).to(device) for n, a in v.items()}
          for k, v in batches.items()}
    flat = [p for _, p in topt.flatten(params)]
    for p in flat:
        p.requires_grad_(True)
    loss = fns["loss"](params, tb["train"])
    it = iter(torch.autograd.grad(loss, flat))
    grads = topt.tree_map(lambda _: next(it), params)
    for p in flat:
        p.requires_grad_(False)
    with torch.no_grad():
        serve = fns["serve"](params, tb["serve"])
        retr = fns["retrieval"](params, tb["retrieval"])
    return {"loss": float(loss.detach()), "grads": grads,
            "serve": serve.cpu(), "retrieval": retr.cpu()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_model_matches_reference(jx, arch):
    """Loss within 1e-5 relative, each gradient, serve and retrieval
    within 1e-5 relative L2 of the reference's, from the reference's
    weights; the gradient tree has the reference's structure."""
    ref = _reference(jx, arch)
    tp = params_from_reference(ref["params"], device="cpu")
    got = _port(arch, tp, ref["batches"])
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)
    want = dict(topt.flatten(params_from_reference(ref["grads"],
                                                   device="cpu")))
    paths = [path for path, _ in topt.flatten(got["grads"])]
    assert paths == list(want)
    for path, g in topt.flatten(got["grads"]):
        assert _rel(g, want[path]) <= RTOL, (path, _rel(g, want[path]))
    for k in ("serve", "retrieval"):
        assert got[k].shape == ref[k].shape, k
        assert _rel(got[k], ref[k]) <= RTOL, (k, _rel(got[k], ref[k]))
    if arch in ("mind", "bert4rec"):
        assert got["serve"].shape == (B, SLATE)
        assert got["retrieval"].shape == (1, C)
    else:
        assert got["retrieval"].shape == (C,)


def test_bert4rec_gelu_is_the_tanh_form(jx, monkeypatch):
    """The reference's ``jax.nn.gelu`` is the tanh approximation: the
    port's encoder within 1e-5 of the reference's, and the same encoder
    with torch's exact erf GELU outside that bound."""
    jnp = jx["jnp"]
    ref = _reference(jx, "bert4rec")
    jcfg = jx["mods"]["bert4rec"].SMOKE_CONFIG
    cfg = tbase.get("bert4rec").smoke_config
    b = ref["batches"]["train"]
    jp = jx["jax"].tree.map(jnp.asarray, ref["params"])
    want = _np(jx["rec"].bert4rec_encode(jcfg, jp, jnp.asarray(b["seq"]),
                                         jnp.asarray(b["seq_mask"])))
    tp = params_from_reference(ref["params"], device="cpu")
    got = trec.bert4rec_encode(cfg, tp, T(b["seq"]), T(b["seq_mask"]))
    assert _rel(got, want) <= RTOL
    np.testing.assert_allclose(float(trec._gelu_tanh(torch.ones(()))),
                               0.841192, atol=1e-6)
    monkeypatch.setattr(trec, "_gelu_tanh", torch.nn.functional.gelu)
    erf = trec.bert4rec_encode(cfg, tp, T(b["seq"]), T(b["seq_mask"]))
    assert _rel(erf, want) > 10 * RTOL


def test_bert4rec_masks_keys_with_neg_inf(jx):
    """A masked key gets no attention weight: the encoder's output at
    valid positions does not move when a masked position's item
    changes."""
    ref = _reference(jx, "bert4rec")
    cfg = tbase.get("bert4rec").smoke_config
    tp = params_from_reference(ref["params"], device="cpu")
    b = ref["batches"]["train"]
    seq, mask = T(b["seq"]).clone(), T(b["seq_mask"])
    row = int(np.argmin(b["seq_mask"].sum(1)))
    pad = int((~b["seq_mask"][row]).sum())
    assert pad > 0
    h0 = trec.bert4rec_encode(cfg, tp, seq, mask)
    seq[row, :pad] = (seq[row, :pad] + 1) % cfg.n_items
    h1 = trec.bert4rec_encode(cfg, tp, seq, mask)
    torch.testing.assert_close(h1[row, pad:], h0[row, pad:], rtol=0,
                               atol=0)


def test_mind_interests_match_reference(jx):
    """The capsules themselves (three unrolled routing iterations from the
    linspace logits, squash with sqrt(n2 + 1e-9)) on ragged histories."""
    jnp = jx["jnp"]
    ref = _reference(jx, "mind")
    jcfg = jx["mods"]["mind"].SMOKE_CONFIG
    b = ref["batches"]["train"]
    jp = jx["jax"].tree.map(jnp.asarray, ref["params"])
    want = _np(jx["rec"].mind_interests(jcfg, jp, jnp.asarray(b["hist"]),
                                        jnp.asarray(b["hist_mask"])))
    tp = params_from_reference(ref["params"], device="cpu")
    got = trec.mind_interests(tbase.get("mind").smoke_config, tp,
                              T(b["hist"]), T(b["hist_mask"]))
    assert got.shape == (B, 4, 16)
    assert _rel(got, want) <= RTOL


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_matches_reference(jx, arch):
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    ref = jx["mods"][arch]
    for ours, theirs in ((mod.CONFIG, ref.CONFIG),
                         (mod.SMOKE_CONFIG, ref.SMOKE_CONFIG)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert type(ours).__name__ == type(theirs).__name__
    spec, rspec = tbase.get(arch), ref.SPEC
    assert spec is mod.SPEC and spec.config is mod.CONFIG
    assert (spec.family, spec.source) == (rspec.family, rspec.source)
    assert [(c.name, c.kind, c.meta, c.note) for c in spec.shapes] == [
        (c.name, c.kind, c.meta, c.note) for c in rspec.shapes]
    assert spec.shapes == tbase.RECSYS_SHAPES
    assert trec.CRITEO_1TB_VOCABS == jx["rec"].CRITEO_1TB_VOCABS
    for name in ("table", "n_sparse", "n_interact", "mask_token"):
        if hasattr(ref.CONFIG, name):
            a, b = getattr(mod.CONFIG, name), getattr(ref.CONFIG, name)
            assert (dataclasses.asdict(a) if dataclasses.is_dataclass(a)
                    else a) == (dataclasses.asdict(b)
                                if dataclasses.is_dataclass(b) else b)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_full_width_shapes_match_reference(jx, arch):
    """The published config's parameters on the meta device: every
    tensor's shape equal to the reference's ``eval_shape`` (dlrm-mlperf's
    fused table 187,767,808 x 128)."""
    jax = jx["jax"]
    jcfg = jx["mods"][arch].CONFIG
    fns = _fns(jx["rec"], arch, jcfg)
    want = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        jax.eval_shape(lambda k: fns["init"](k, jcfg),
                                       jax.random.PRNGKey(0)))
    cfg = tbase.get(arch).config
    ours = _fns(trec, arch, cfg)["init"](None, cfg, device="meta")
    got = {p: tuple(t.shape) for p, t in topt.flatten(ours)}
    assert got == {p: tuple(t.shape) for p, t in topt.flatten(want)}
    if arch == "dlrm-mlperf":
        assert got[("table",)] == (187_767_808, 128)


# ----------------------------------------------------------------- on card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_model_on_card_matches_cpu(card, arch):
    """The same weights (from a generator) and batches on the card and on
    the CPU: loss, every gradient, serve and retrieval within 1e-4
    relative L2."""
    cfg = tbase.get(arch).smoke_config
    init = _fns(trec, arch, cfg)["init"]
    p = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batches = _batches(arch, cfg, seed=1)
    out = {d: _port(arch, topt.tree_map(lambda t, d=d: t.to(d).clone(), p),
                    batches, device=d) for d in ("cpu", card)}
    a, b = out[card], out["cpu"]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    for (path, x), (_, y) in zip(topt.flatten(a["grads"]),
                                 topt.flatten(b["grads"])):
        assert _rel(x.cpu(), y) <= 1e-4, path
    for k in ("serve", "retrieval"):
        assert _rel(a[k], b[k]) <= 1e-4, k
