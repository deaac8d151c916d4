"""Prop. 4.3 on the port — topological fidelity, E_EMST ⊆ E_RNG ⊆ E_MCGI
(alpha >= 1) — the reference's ``tests/test_connectivity.py`` run through
:mod:`repro_torch.core.theory`, plus the oracles' edge sets against the
reference's on integer coordinates (every distance exact, so the sets must
be equal).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build, theory  # noqa: E402
from repro_torch.core.search import medoid  # noqa: E402

torch.set_num_threads(1)


def _mcgi(x, alpha, degree=None):
    return theory.mcgi_complete_pool_edges(x, alpha, degree=degree,
                                           device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inclusion_chain_complete_pool(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    emst = theory.emst_edges(x)
    rngg = theory.rng_edges(x)
    mcgi = _mcgi(x, np.full((40,), 1.0, np.float32))
    assert emst <= rngg, "Toussaint inclusion violated"
    assert rngg <= mcgi, f"RNG ⊄ MCGI: missing {rngg - mcgi}"
    assert theory.is_connected(40, mcgi)


def test_inclusion_with_heterogeneous_alpha():
    """Per-node alpha(u) >= 1 (the MCGI regime) preserves the chain."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 4)).astype(np.float32)
    alpha = rng.uniform(1.0, 1.5, size=30).astype(np.float32)
    rngg = theory.rng_edges(x)
    mcgi = _mcgi(x, alpha)
    assert rngg <= mcgi
    assert theory.is_connected(30, mcgi)


def test_built_index_navigable():
    """Every node reachable from the medoid on a graph the port built."""
    pytest.importorskip("jax")
    from repro.data import make_dataset

    x, _ = make_dataset("tiny-mixture", seed=0)
    x = np.array(x)[:800]
    cfg = build.BuildConfig(degree=24, beam_width=48, iters=2, batch=256,
                            max_hops=96)
    idx = build.build_mcgi(x, cfg, device="cpu")
    reach = theory.reachable_from(idx.adj.numpy(), int(idx.entry))
    assert int(idx.entry) == int(medoid(torch.from_numpy(x)))
    assert reach.mean() > 0.999, reach.mean()


def test_alpha_below_one_can_break_rng():
    """Sanity of the oracle: alpha < 1 (disallowed) gives a pruned graph no
    larger than alpha = 1's."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(25, 3)).astype(np.float32)
    mcgi = _mcgi(x, np.full((25,), 0.5, np.float32))
    assert len(mcgi) <= len(_mcgi(x, np.ones((25,), np.float32)))


def test_is_connected_and_reachable_edge_cases():
    assert theory.is_connected(1, set())
    assert not theory.is_connected(2, set())
    assert not theory.is_connected(4, {(0, 1), (2, 3)})
    adj = np.array([[1, -1], [-1, -1], [0, -1]], np.int32)
    np.testing.assert_array_equal(theory.reachable_from(adj, 0),
                                  [True, True, False])
    np.testing.assert_array_equal(theory.reachable_from(adj, 2),
                                  [True, True, True])


@pytest.mark.parametrize("seed,degree", [(0, None), (1, None), (2, 4)])
def test_edge_sets_equal_reference_on_integer_coordinates(seed, degree):
    pytest.importorskip("jax")
    from repro.core import theory as jtheory

    rng = np.random.default_rng(seed)
    x = rng.integers(-5, 6, (28, 3)).astype(np.float32)
    alpha = rng.choice(np.array([1.0, 1.25, 1.5], np.float32), 28)
    np.testing.assert_array_equal(theory.pairwise_np(x),
                                  jtheory.pairwise_np(x))
    assert theory.rng_edges(x) == jtheory.rng_edges(x)
    assert theory.emst_edges(x) == jtheory.emst_edges(x)
    assert _mcgi(x, alpha, degree) == jtheory.mcgi_complete_pool_edges(
        x, alpha, degree=degree)
