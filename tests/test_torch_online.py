"""Online-MCGI (Algorithm 2) in the port against the reference:
``bootstrap_stats``, ``LidProfile.zscore``, ``_rewire_batch_online`` and
``build_online_mcgi``, on the same numpy inputs, and the launcher's
``--online``.

Tolerances: on integer-valued data every walk and prune is exact, so with
``alpha_min == alpha_max`` (alpha then does not depend on LID) the whole
build must be bit-identical: adj, alpha and entry; LID, mu and sigma within
rtol 1e-4.  With ``alpha_min < alpha_max`` alpha(u) comes from log, sqrt and
exp, so it is held in parts: lid_u within rtol 1e-4, alpha_u within 1e-4,
and the prune fed the reference's alpha_u bit-identical.  On float data the
build is held by the recall@10 of an exact search over each graph (within
0.02) and a spread of alpha (std > 1e-3).  The port's tests inject the
reference's random draws (``init_adj``, ``perms``, ``sample_idx``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build as jbuild  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro.core import lid as jlid  # noqa: E402
from repro.core import online as jonline  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core import lid as tlid  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy
SAMPLE = 64
# Ragged: 200 % 64 != 0, so every round ends on a short batch.
N, D = 200, 6
KW = dict(degree=8, beam_width=12, iters=2, batch=64, max_hops=40,
          reverse_cap=4, lid_k=8)


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _draws(n: int, cfg, sample: int = SAMPLE):
    """The reference's three draws from PRNGKey(cfg.seed)."""
    key = jax.random.PRNGKey(cfg.seed)
    init_adj = np.array(jbuild.random_graph(n, cfg.degree, key))
    perms = [np.array(jax.random.permutation(jax.random.fold_in(key, it + 1),
                                               n)) for it in range(cfg.iters)]
    sample_idx = np.array(jax.random.choice(jax.random.fold_in(key, 17), n,
                                            (min(sample, n),), replace=False))
    return dict(init_adj=init_adj, perms=perms, sample_idx=sample_idx)


def _both_builds(x, kw, sample: int = SAMPLE):
    jcfg, tcfg = jbuild.BuildConfig(**kw), tbuild.BuildConfig(**kw)
    want = jonline.build_online_mcgi(jnp.asarray(x), jcfg, sample=sample)
    got = tonline.build_online_mcgi(x, tcfg, sample=sample, device="cpu",
                                    **_draws(x.shape[0], jcfg, sample))
    return got, want


# ------------------------------------------------------------ bootstrap


@pytest.mark.parametrize("sample", [32, 500])
def test_bootstrap_stats_matches_reference(sample):
    """Given the reference's ``jax.random.choice`` draw (the whole set when
    ``sample`` > N), mu and sigma agree within rtol 1e-4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jmu, jsig = jlid.bootstrap_stats(jnp.asarray(x), key, sample=sample, k=8)
    idx = np.array(jax.random.choice(key, 300, (min(sample, 300),),
                                     replace=False))
    mu, sig = tlid.bootstrap_stats(T(x), sample=sample, k=8, sample_idx=idx)
    np.testing.assert_allclose(float(mu), float(jmu), rtol=1e-4)
    np.testing.assert_allclose(float(sig), float(jsig), rtol=1e-4)


def test_bootstrap_stats_own_draw():
    """The port's own draw: distinct ids, the same for the same seed, and
    the statistics of that draw."""
    rng = np.random.default_rng(1)
    x = T(rng.standard_normal((300, 8)).astype(np.float32))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(tlid.bootstrap_stats(x, gen, sample=40, k=8))
        idx = torch.randperm(300, generator=torch.Generator().manual_seed(5))
        want = tlid.bootstrap_stats(x, sample=40, k=8,
                                    sample_idx=idx[:40].numpy())
        assert torch.equal(runs[-1][0], want[0])
        assert torch.equal(runs[-1][1], want[1])
    assert torch.equal(runs[0][0], runs[1][0])
    assert float(runs[0][1]) > 0


@pytest.mark.parametrize("sigma", [2.5, 0.0])
def test_zscore(sigma):
    """Eq. 7 with sigma clamped at 1e-6, as the reference's."""
    lid = np.array([3.0, 7.5, 12.0, 7.0], np.float32)
    want = jlid.LidProfile(lid=jnp.asarray(lid), mu=jnp.float32(7.0),
                           sigma=jnp.float32(sigma)).zscore(jnp.asarray(lid))
    got = tlid.LidProfile(lid=T(lid), mu=torch.tensor(7.0),
                          sigma=torch.tensor(sigma)).zscore(T(lid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------- rewire


def _rewire_problem(seed: int, kw):
    rng = np.random.default_rng(seed)
    x = _ints(rng, (N, D))
    cfg = jbuild.BuildConfig(**kw)
    adj = np.array(jbuild.random_graph(N, cfg.degree,
                                       jax.random.PRNGKey(seed)))
    node_ids = rng.permutation(N)[:40].astype(np.int32)
    entry = int(tsearch.medoid(T(x)))
    return x, adj, node_ids, entry, np.float32(7.0), np.float32(2.0)


def test_rewire_batch_online_in_parts():
    """alpha in [1, 1.5] on integer data: lid_u within rtol 1e-4, alpha_u
    within 1e-4, and the prune fed the reference's alpha_u gives the
    reference's rows bit for bit."""
    kw = dict(KW, alpha_min=1.0, alpha_max=1.5)
    x, adj, ids, entry, mu, sigma = _rewire_problem(2, kw)
    want = jonline._rewire_batch_online(
        jnp.asarray(x), jnp.asarray(adj), jnp.asarray(mu),
        jnp.asarray(sigma), jnp.int32(entry), jnp.asarray(ids),
        jbuild.BuildConfig(**kw))
    cfg = tbuild.BuildConfig(**kw)
    rows, rows_d2, alpha_u, lid_u = tonline._rewire_batch_online(
        T(x), T(adj), torch.tensor(mu), torch.tensor(sigma),
        torch.tensor(entry, dtype=torch.int32), T(ids), cfg)
    np.testing.assert_allclose(lid_u.numpy(), np.asarray(want[3]), rtol=1e-4)
    np.testing.assert_allclose(alpha_u.numpy(), np.asarray(want[2]),
                               atol=1e-4)
    assert float(np.std(np.asarray(want[2]))) > 1e-3   # alpha really varies
    beam, _, _ = tsearch.beam_search_exact(
        T(x), T(adj), T(x[ids]), torch.tensor(entry, dtype=torch.int32),
        beam_width=cfg.beam_width, max_hops=cfg.max_hops, k=cfg.beam_width)
    pool = torch.cat([beam, T(adj)[T(ids).long()]], 1)
    fed, fed_d2 = tprune.robust_prune_batch(
        T(x), T(ids), pool, T(np.array(want[2])), cfg.degree)
    np.testing.assert_array_equal(fed.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(fed_d2.numpy(), np.asarray(want[1]))
    # The reference's prune on the same pool agrees with its own rewire.
    jrows, _ = jprune.robust_prune_batch(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(pool.numpy()),
        want[2], cfg.degree)
    np.testing.assert_array_equal(np.asarray(jrows), np.asarray(want[0]))


def test_rewire_batch_online_constant_alpha_bit_identical():
    kw = dict(KW, alpha_min=1.2, alpha_max=1.2)
    x, adj, ids, entry, mu, sigma = _rewire_problem(3, kw)
    want = jonline._rewire_batch_online(
        jnp.asarray(x), jnp.asarray(adj), jnp.asarray(mu),
        jnp.asarray(sigma), jnp.int32(entry), jnp.asarray(ids),
        jbuild.BuildConfig(**kw))
    got = tonline._rewire_batch_online(
        T(x), T(adj), torch.tensor(mu), torch.tensor(sigma),
        torch.tensor(entry, dtype=torch.int32), T(ids),
        tbuild.BuildConfig(**kw))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-4)


# ---------------------------------------------------------------- build


def test_build_online_bit_identical_integer_ragged():
    """alpha_min == alpha_max on integer data, N % batch != 0, two rounds:
    adj, alpha and entry bit-identical; lid, mu, sigma within rtol 1e-4."""
    rng = np.random.default_rng(4)
    x = _ints(rng, (N, D))
    assert N % KW["batch"] != 0
    got, want = _both_builds(x, dict(KW, alpha_min=1.2, alpha_max=1.2))
    np.testing.assert_array_equal(got.adj.numpy(), np.asarray(want.adj))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(want.alpha))
    assert int(got.entry) == int(want.entry)
    np.testing.assert_allclose(got.lid.numpy(), np.asarray(want.lid),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got.mu), float(want.mu), rtol=1e-4)
    np.testing.assert_allclose(float(got.sigma), float(want.sigma),
                               rtol=1e-4)


def test_build_online_float_recall_within_bound():
    """alpha in [1, 1.5] on float data: recall@10 of the same exact search
    over each graph within 0.02, and alpha spread (std > 1e-3)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    q = rng.standard_normal((60, 16)).astype(np.float32)
    kw = dict(degree=12, beam_width=24, iters=2, batch=128, max_hops=64,
              reverse_cap=8, lid_k=10)
    got, want = _both_builds(x, kw, sample=128)
    _, gt = jdist.brute_force_topk(jnp.asarray(q), jnp.asarray(x), k=10)
    gt = np.asarray(gt)

    def recall(adj, entry):
        ids, _, _ = tsearch.beam_search_exact(
            T(x), T(np.asarray(adj)), T(q),
            torch.tensor(int(entry), dtype=torch.int32), beam_width=24,
            max_hops=64, k=10)
        return np.mean([np.isin(a, b).mean() for a, b in zip(ids.numpy(),
                                                             gt)])

    r_port, r_ref = recall(got.adj, got.entry), recall(want.adj, want.entry)
    assert r_ref > 0.8
    assert abs(r_port - r_ref) <= 0.02, (r_port, r_ref)
    assert float(got.alpha.std()) > 1e-3
    assert float(got.alpha.min()) >= 1.0 and float(got.alpha.max()) <= 1.5
    np.testing.assert_allclose(float(got.mu), float(want.mu), rtol=1e-4)


@pytest.mark.parametrize("iters", [1, 2])
def test_port_builds_ragged_deterministic(iters):
    """Two builds from the port's own draws over a ragged tail agree bit
    for bit (the wrap-padded batches of the reference scatter only their
    real prefix); the phase clock has the online build's four phases."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((390, 12)).astype(np.float32)
    cfg = tbuild.BuildConfig(degree=16, beam_width=32, iters=iters,
                             batch=128, max_hops=64)
    timings = {}
    a = tcore.build_online_mcgi(x, cfg, device="cpu", timings=timings)
    b = tcore.build_online_mcgi(x, cfg, device="cpu")
    assert set(timings) == {"bootstrap", "rewire_walks", "prune",
                            "reverse_insert"}
    for name in ("adj", "alpha", "lid", "mu", "sigma", "entry"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    ids, _, _ = tsearch.beam_search_exact(T(x), a.adj, T(x[:40]), a.entry,
                                          beam_width=32, k=1)
    assert (ids[:, 0].numpy() == np.arange(40)).mean() >= 0.95


def test_launcher_online_equals_direct_build(tmp_path, capsys):
    """``--online --index`` builds with ``build_online_mcgi`` and saves the
    index: its graph equals a direct build on the same data and config."""
    from repro_torch.data import make_dataset
    from repro_torch.index import load_index
    from repro_torch.launch import serve

    p = tmp_path / "online.npz"
    serve.main(["--device", "cpu", "--online", "--n", "400", "--degree",
                "8", "--l-build", "16", "--build-batch", "96", "--batch",
                "8", "--num-batches", "2", "--m-pq", "4", "--index", str(p)])
    out = capsys.readouterr().out
    assert "bootstrap: mu=" in out and "online refinement round" in out
    assert "recall@10=" in out
    x, _ = make_dataset("tiny-mixture", seed=0, device="cpu", n=400)
    want = tonline.build_online_mcgi(
        x, tbuild.BuildConfig(degree=8, beam_width=16, batch=96),
        device="cpu")
    got = load_index(p, device="cpu").graph
    for name in ("adj", "alpha", "lid", "mu", "sigma", "entry"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
