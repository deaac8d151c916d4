"""The port's GAT against the reference's, on the CPU.

* ``gat_forward``, ``gat_loss`` and ``gat_graph_loss`` on graphs with
  padded edges (the ghost row ``n_nodes``, which JAX's gather clamps to
  the last row) and a node with no incoming edge (``segment_max``'s
  -inf identity, then 0): logits, loss, accuracy and every gradient
  within 1e-5; a graph id outside [0, G) dropped from the pooling.
* ``NeighborSampler`` blocks equal to the reference's for the same seed,
  and ``pad_edges``.
* A GAT train step with int8 compression: the gradients, the compressed
  gradients and error feedback (one scale a layer tensor: the GAT's
  ``layers`` is a list, not the transformer's stack), and the updated
  parameters equal the reference's leaf for leaf.
* The reference's learning test on the port, the gat-cora config and its
  four cells field for field.
* A ``gpu`` test runs the smoke GAT on the card against the CPU; the
  reference is imported in a fixture, so it runs without JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import gat_cora as tcora  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.training import compression as tcomp  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.training.data import random_graph_data  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
RTOL = 1e-5
N, E, E_MAX, D_IN, CLASSES = 60, 300, 384, 12, 5
LONELY = 7          # a node with no incoming edge


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import gat_cora as jcora
    from repro.models import gnn as jgnn
    from repro.training import compression as jcomp
    from repro.training import optimizer as jopt
    return dict(jax=jax, jnp=jnp, gnn=jgnn, cora=jcora, comp=jcomp,
                opt=jopt)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _graph(seed: int = 0) -> dict:
    """A node-level batch: N nodes, E edges padded to E_MAX with the ghost
    N, node LONELY with no incoming edge (it still sends)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst[dst == LONELY] = LONELY + 1
    src[:5] = LONELY
    return {"features": rng.standard_normal((N, D_IN)).astype(np.float32),
            "edge_index": tgnn.pad_edges(src, dst, E_MAX, N),
            "labels": rng.integers(0, CLASSES, N).astype(np.int32),
            "mask": rng.uniform(size=N) < 0.6}


def _graphs(seed: int = 1) -> dict:
    """A graph-level batch: 6 graphs of 9 nodes in a block-diagonal
    batch, 6 padded nodes (graph id 6, outside [0, 6)), padded edges."""
    rng = np.random.default_rng(seed)
    g, per = 6, 9
    src = np.concatenate([rng.integers(0, per, 14) + per * i
                          for i in range(g)])
    dst = np.concatenate([rng.integers(0, per, 14) + per * i
                          for i in range(g)])
    n = g * per + 6
    gid = np.concatenate([np.repeat(np.arange(g), per),
                          np.full(6, g)]).astype(np.int32)
    return {"features": rng.standard_normal((n, D_IN)).astype(np.float32),
            "edge_index": tgnn.pad_edges(src, dst, 128, n),
            "graph_ids": gid,
            "labels": rng.integers(0, 2, g).astype(np.int32)}


CFGS = {"smoke": tcora.SMOKE_CONFIG.for_regime(D_IN, CLASSES),
        "published": tcora.CONFIG.for_regime(D_IN, CLASSES),
        "three layers": tgnn.GatConfig(d_in=D_IN, d_hidden=4, n_heads=3,
                                       n_classes=CLASSES, n_layers=3)}


def _jcfg(jx, cfg):
    return jx["gnn"].GatConfig(**dataclasses.asdict(cfg))


def _ref_params(jx, cfg, seed: int = 0):
    jp = jx["gnn"].gat_init(jx["jax"].random.PRNGKey(seed), _jcfg(jx, cfg))
    return jp, params_from_reference(jx["jax"].tree.map(np.asarray, jp),
                                     device="cpu")


def _port_grads(loss_fn, params, batch):
    flat = [p for _, p in topt.flatten(params)]
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch)
    it = iter(torch.autograd.grad(loss, flat))
    for p in flat:
        p.requires_grad_(False)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            topt.tree_map(lambda _: next(it), params))


def _check(jx, name: str, level: str, cfg, batch):
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg = _jcfg(jx, cfg)
    jp, tp = _ref_params(jx, cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: T(v) for k, v in batch.items()}
    jloss = getattr(jx["gnn"], name)
    tloss = getattr(tgnn, name)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg, p, b), has_aux=True))(jp, jb)
    loss, m, grads = _port_grads(lambda p, b: tloss(cfg, p, b), tp, tb)
    np.testing.assert_allclose(loss, float(want), rtol=RTOL)
    np.testing.assert_allclose(m["acc"], float(wm["acc"]), rtol=0)
    want_g = dict(topt.flatten(params_from_reference(
        jax.tree.map(np.asarray, wg), device="cpu")))
    for path, g in topt.flatten(grads):
        assert _rel(g, want_g[path]) <= RTOL, (level, path)
    logits = tgnn.gat_forward(cfg, tp, tb["features"], tb["edge_index"])
    want_l = _np(jax.jit(lambda p, x, ei: jx["gnn"].gat_forward(
        jcfg, p, x, ei))(jp, jb["features"], jb["edge_index"]))
    assert _rel(logits, want_l) <= RTOL
    return logits


@pytest.mark.parametrize("cfg", list(CFGS))
def test_gat_loss_matches_reference(jx, cfg):
    """Padded edges and a node with no incoming edge: logits, loss,
    accuracy and every gradient.  The lonely node aggregates nothing, so
    its logits are exactly 0."""
    logits = _check(jx, "gat_loss", "node", CFGS[cfg], _graph())
    assert torch.isfinite(logits).all()
    assert float(logits[LONELY].abs().max()) == 0.0


@pytest.mark.parametrize("cfg", ["smoke", "published"])
def test_gat_graph_loss_matches_reference(jx, cfg):
    _check(jx, "gat_graph_loss", "graph", CFGS[cfg], _graphs())


def test_padded_edges_do_not_reach_an_output():
    """Adding ghost edges (src = dst = N) changes no logit: the ghost
    segment is sliced off and the gathers clamp to the last row."""
    cfg = CFGS["smoke"]
    p = tgnn.gat_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = _graph()
    ei = b["edge_index"][:, :E]
    x = T(b["features"])
    a = tgnn.gat_forward(cfg, p, x, T(tgnn.pad_edges(ei[0], ei[1], E, N)))
    c = tgnn.gat_forward(cfg, p, x, T(tgnn.pad_edges(ei[0], ei[1], 4 * E,
                                                     N)))
    torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_neighbor_sampler_matches_reference(jx):
    """The same graph and seed give the reference's blocks, call after
    call; ``pad_edges`` gives the reference's array."""
    feats, ei, labels, _ = random_graph_data(2000, 16000, 4, 3, seed=5)
    ours = tgnn.NeighborSampler(ei, 2000, seed=3)
    ref = jx["gnn"].NeighborSampler(ei, 2000, seed=3)
    np.testing.assert_array_equal(ours.indptr, ref.indptr)
    np.testing.assert_array_equal(ours.src_sorted, ref.src_sorted)
    seeds = np.random.default_rng(9).choice(2000, 64, replace=False)
    for fanouts in ((15, 10), (5, 3), (15, 10)):
        a = ours.sample_block(seeds, fanouts)
        b = ref.sample_block(seeds, fanouts)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert (a[0][:64] == seeds).all()
        np.testing.assert_array_equal(
            tgnn.pad_edges(a[1], a[2], 8192, len(a[0])),
            jx["gnn"].pad_edges(a[1], a[2], 8192, len(a[0])))
    with pytest.raises(ValueError):
        tgnn.pad_edges(np.arange(5), np.arange(5), 4, 9)


def test_gat_train_step_with_compression_matches_reference(jx):
    """Two steps at the GAT cells' optimizer (lr 5e-3, weight decay 5e-4)
    with int8 compression.  Gradients within 1e-5 of the reference's; the
    reference's compression (eager) on the port's gradients gives the
    port's compressed gradients and error feedback bit for bit, one scale
    a tensor (each GAT layer's ``w`` its own); the reference's AdamW then
    gives the port's parameters and moments within 1e-6 of each tensor's
    largest magnitude."""
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = CFGS["published"]
    jcfg = _jcfg(jx, cfg)
    jp, tp = _ref_params(jx, cfg, seed=3)
    batch = _graph(seed=4)
    tb = {k: T(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    names = {n: stacked for n, _, stacked in topt.reference_leaves(tp)}
    assert names == {f"layers/{i}/{k}": False for i in range(2)
                     for k in ("a_dst", "a_src", "w")}
    assert tcomp.compressed_allreduce_bytes(tp) == \
        jx["comp"].compressed_allreduce_bytes(jp)
    oc = dict(lr=5e-3, weight_decay=5e-4)
    jopt_cfg = jx["opt"].AdamWConfig(**oc)
    step = tts.make_train_step(lambda p, b: tgnn.gat_loss(cfg, p, b),
                               topt.AdamWConfig(**oc), compress_grads=True)
    ts = tts.init_train_state(tp, compress_grads=True)
    jstate = jx["opt"].adamw_init(jp)
    jerr = jx["comp"].init_error_feedback(jp)
    ref_grad = jax.jit(jax.grad(
        lambda p: jx["gnn"].gat_loss(jcfg, p, jb)[0]))
    for _ in range(2):
        _, _, g = _port_grads(lambda p, b: tgnn.gat_loss(cfg, p, b),
                              ts.params, tb)
        want = dict(topt.flatten(params_from_reference(
            jax.tree.map(np.asarray, ref_grad(jp)), device="cpu")))
        for path, x in topt.flatten(g):
            assert _rel(x, want[path]) <= RTOL, path
        g_np = topt.tree_map(lambda t: t.numpy().copy(), g)
        scales = [float(jx["comp"].quantize_leaf(jnp.asarray(
            lp["w"] + e["w"]))[1]) for lp, e in
            zip(g_np["layers"], jax.tree.map(np.asarray, jerr)["layers"])]
        assert scales[0] != scales[1]
        want_g, jerr = jx["comp"].compress_grads_with_feedback(
            jax.tree.map(jnp.asarray, g_np), jerr)
        got_g, _ = tcomp.compress_grads_with_feedback(
            topt.tree_map(torch.clone, g),
            topt.tree_map(torch.clone, ts.error_feedback))
        jp, jstate, jm = jx["opt"].adamw_update(jopt_cfg, jp, want_g, jstate)
        ts, tm = step(ts, tb)
        for got, ref in ((got_g, want_g), (ts.error_feedback, jerr)):
            ref = dict(topt.flatten(params_from_reference(
                jax.tree.map(np.asarray, ref), device="cpu")))
            for path, a in topt.flatten(got):
                np.testing.assert_array_equal(a.numpy(), ref[path].numpy(),
                                              err_msg=str(path))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
    for got, ref in ((ts.params, jp), (ts.opt["m"], jstate["m"]),
                     (ts.opt["v"], jstate["v"])):
        ref = dict(topt.flatten(params_from_reference(
            jax.tree.map(np.asarray, ref), device="cpu")))
        for path, a in topt.flatten(got):
            b = ref[path]
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * float(b.abs().max()),
                                       err_msg=str(path))
    assert int(ts.step) == 2


def test_reference_leaves_stack_only_the_transformer():
    """The transformer's layers stack (its reference leaves group a name
    across layers); any other tree with a ``layers`` list does not."""
    cfg = tbase.get("qwen2-7b").smoke_config
    lm = tt.init_lm(cfg, None, device="meta")
    assert topt.stacks_layers(lm)
    stacked = [n for n, ts, s in topt.reference_leaves(lm) if s]
    assert "layers/ln_attn" in stacked
    gat = tgnn.gat_init(None, CFGS["smoke"], device="meta")
    assert not topt.stacks_layers(gat)
    assert not topt.stacks_layers({"layers": lm["layers"]})
    assert all(len(ts) == 1 and not s
               for _, ts, s in topt.reference_leaves(gat))


def test_gat_learns_on_homophilous_graph():
    """The reference's learning test on the port (const lr 1e-2, 30
    steps): the last loss below 0.7 of the first, accuracy above 0.5."""
    feats, ei, labels, mask = random_graph_data(300, 2000, 16, 4, seed=0)
    cfg = tgnn.GatConfig(d_in=16, d_hidden=8, n_heads=4, n_classes=4)
    p = tgnn.gat_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"features": T(feats),
             "edge_index": T(tgnn.pad_edges(ei[0], ei[1], 2048, 300)),
             "labels": T(labels), "mask": T(mask)}
    step = tts.make_train_step(
        lambda pp, b: tgnn.gat_loss(cfg, pp, b),
        topt.AdamWConfig(lr=1e-2, weight_decay=0.0, schedule="const"))
    state = tts.init_train_state(p)
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.7 * losses[0]
    assert float(m["acc"]) > 0.5


def test_config_matches_reference(jx):
    ref = jx["cora"]
    for ours, theirs in ((tcora.CONFIG, ref.CONFIG),
                         (tcora.SMOKE_CONFIG, ref.SMOKE_CONFIG)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert dataclasses.asdict(ours.for_regime(1433, 7)) == \
            dataclasses.asdict(theirs.for_regime(1433, 7))
    assert (tcora._MB_NODES, tcora._MB_EDGES) == (ref._MB_NODES,
                                                  ref._MB_EDGES)
    # pad_to(1024 x 166, 256): the reference's comment says 170,240.
    assert (tcora._MB_NODES, tcora._MB_EDGES) == (169_984, 168_960)
    spec = tbase.get("gat-cora")
    assert spec is tcora.SPEC and spec.config is tcora.CONFIG
    assert (spec.family, spec.source) == (ref.SPEC.family, ref.SPEC.source)
    assert [(c.name, c.kind, c.meta, c.note) for c in spec.shapes] == [
        (c.name, c.kind, c.meta, c.note) for c in ref.SPEC.shapes]
    full = tcora.CONFIG.for_regime(1433, 7)
    shapes = {p: tuple(t.shape) for p, t in topt.flatten(
        tgnn.gat_init(None, full, device="meta"))}
    want = jx["jax"].eval_shape(
        lambda k: jx["gnn"].gat_init(k, _jcfg(jx, full)),
        jx["jax"].random.PRNGKey(0))
    assert shapes == {("layers", i, k): tuple(want["layers"][i][k].shape)
                      for i in range(2) for k in ("w", "a_src", "a_dst")}


# ----------------------------------------------------------------- on card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,make", [("gat_loss", _graph),
                                       ("gat_graph_loss", _graphs)])
def test_gat_on_card_matches_cpu(card, name, make):
    """The smoke GAT on the card (ghost rows, segment max and sums by
    atomics) against the CPU: loss and every gradient within 1e-4
    relative L2."""
    cfg = CFGS["smoke"]
    p = tgnn.gat_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = make()
    fn = getattr(tgnn, name)
    out = {}
    for d in ("cpu", card):
        pp = topt.tree_map(lambda t, d=d: t.to(d).clone(), p)
        out[str(d)] = _port_grads(lambda q, b: fn(cfg, q, b), pp,
                                  {k: T(v).to(d) for k, v in batch.items()})
    a, b = out[str(card)], out["cpu"]
    np.testing.assert_allclose(a[0], b[0], rtol=1e-4)
    for (path, x), (_, y) in zip(topt.flatten(a[2]), topt.flatten(b[2])):
        assert _rel(x.cpu(), y) <= 1e-4, path
