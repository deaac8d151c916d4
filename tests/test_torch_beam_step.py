"""The port's plain beam step (``repro_torch.kernels.ref.beam_step_ref``)
against the reference's oracle and its Pallas kernel in interpret mode.

Tables and contexts are integer-valued, so every float32 sum is exact in
any order and the walks must agree bit for bit at every hop.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import search as jsearch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.beam_step import beam_step as pallas_beam_step  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)


def _walk_problem(kind, n, r, beam, q, seed):
    """Numpy walk problem: dup-free adjacency, query i entering at node i,
    integer-valued tables/contexts, ragged budgets and hop limits."""
    rng = np.random.default_rng(seed)
    adj = np.stack([rng.choice(n, size=r, replace=False)
                    for _ in range(n)]).astype(np.int32)
    adj[rng.random(adj.shape) < 0.1] = -1           # INVALID slots
    if kind == "pq":
        m, k = 8, 16
        table = rng.integers(0, k, (n, m)).astype(np.uint8)
        ctxs = rng.integers(0, 32, (q, m, k)).astype(np.float32)
        d0 = ctxs[np.arange(q)[:, None], np.arange(m),
                  table[:q].astype(int)].sum(axis=1)
    else:
        d = 24
        table = rng.integers(-6, 7, (n, d)).astype(np.float32)
        ctxs = rng.integers(-6, 7, (q, d)).astype(np.float32)
        d0 = ((table[:q] - ctxs) ** 2).sum(axis=1)
    entries = np.arange(q, dtype=np.int32)
    beam_ids = np.full((q, beam), -1, np.int32)
    beam_d = np.full((q, beam), np.inf, np.float32)
    beam_ids[:, 0], beam_d[:, 0] = entries, d0
    visited = np.zeros((q, (n + 31) // 32), np.uint32)
    visited[np.arange(q), entries // 32] = np.uint32(1) << (entries % 32)
    state = (beam_ids, beam_d, np.zeros((q, beam), bool), visited,
             np.zeros((q,), np.int32), np.ones((q,), np.int32))
    budgets = rng.integers(max(2, beam // 2), beam + 1, q).astype(np.int32)
    hop_limits = rng.integers(2, 7, q).astype(np.int32)
    return state, ctxs, adj, table, budgets, hop_limits


def _to_torch(state):
    out = []
    for a in state:
        a = np.asarray(a)
        out.append(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                    else a.copy()))
    return tuple(out)


def _assert_same(torch_state, jax_state):
    for got, want in zip(torch_state, jax_state):
        want = np.asarray(want)
        got = got.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["exact", "pq"])
@pytest.mark.parametrize("n,r,beam,q", [(200, 8, 16, 3), (64, 4, 8, 1),
                                        (130, 6, 12, 2)])
def test_beam_step_sweep(kind, n, r, beam, q):
    """Six hops: the port's plain step equals the reference oracle (jitted)
    and the Pallas kernel (interpret mode) bit for bit after every hop."""
    st, ctxs, adj, table, budgets, hop_limits = _walk_problem(
        kind, n, r, beam, q, seed=n + beam)
    st_j = st_k = tuple(jnp.asarray(a) for a in st)
    st_t = _to_torch(st)
    args_j = (jnp.asarray(ctxs), jnp.asarray(adj), jnp.asarray(table),
              jnp.asarray(budgets), jnp.asarray(hop_limits))
    args_t = (torch.from_numpy(ctxs), torch.from_numpy(adj),
              torch.from_numpy(table), torch.from_numpy(budgets),
              torch.from_numpy(hop_limits))
    step_j = jax.jit(functools.partial(jref.beam_step_ref, kind=kind))
    for _ in range(6):
        st_j = step_j(st_j, *args_j)
        st_k = pallas_beam_step(st_k, *args_j, kind=kind, interpret=True)
        st_t = tref.beam_step_ref(st_t, *args_t, kind=kind)
        _assert_same(st_t, st_j)
        _assert_same(st_t, st_k)
    # Every lane is terminal by now: one more step is the identity.
    again = tref.beam_step_ref(st_t, *args_t, kind=kind)
    for a, b in zip(again, st_t):
        assert torch.equal(a, b)


def test_beam_step_respects_budget():
    """budget=1 is the greedy walk, diverges from the full-beam walk, and
    stays bit-identical to the reference at each budget."""
    st0, ctxs, adj, table, _, _ = _walk_problem("exact", 200, 8, 16, 4, 7)
    hop_limits = np.full((4,), 6, np.int32)
    step_j = jax.jit(functools.partial(jref.beam_step_ref, kind="exact"))
    runs = {}
    for b in (1, 16):
        budgets = np.full((4,), b, np.int32)
        st_t = _to_torch(st0)
        st_j = tuple(jnp.asarray(a) for a in st0)
        for _ in range(6):
            st_t = tref.beam_step_ref(
                st_t, torch.from_numpy(ctxs), torch.from_numpy(adj),
                torch.from_numpy(table), torch.from_numpy(budgets),
                torch.from_numpy(hop_limits), kind="exact")
            st_j = step_j(st_j, jnp.asarray(ctxs), jnp.asarray(adj),
                          jnp.asarray(table), jnp.asarray(budgets),
                          jnp.asarray(hop_limits))
        _assert_same(st_t, st_j)
        runs[b] = st_t
    assert not torch.equal(runs[1][1], runs[16][1])


@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_active_counter_counts_movable_lanes(kind):
    """The counter a walk leaves for ``run_batch`` to read gains exactly the
    lanes that can still take a hop after the step (a one-hop walk)."""
    st, ctxs, adj, table, budgets, hop_limits = _walk_problem(
        kind, 200, 8, 16, 5, seed=3)
    st_t = _to_torch(st)
    args = (torch.from_numpy(ctxs), torch.from_numpy(adj),
            torch.from_numpy(table), torch.from_numpy(budgets),
            torch.from_numpy(hop_limits))
    for _ in range(7):
        count = torch.zeros((1,), dtype=torch.int32)
        st_t = ops.beam_step(st_t, *args, kind=kind, active_count=count)
        want = tref.lane_active(st_t[0], st_t[2], st_t[4], args[3], args[4])
        assert int(count) == int(want.sum())
    assert int(count) == 0


@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_run_batch_equals_reference_run_batch(kind):
    """The port's ``run_batch`` (one ``ops.beam_walk`` to convergence)
    equals the reference's pieces bit for bit: its vmapped per-lane
    ``while_loop`` over the hop body (``BeamStepKernel``) and its fused
    hop loop (``PallasBeamStep``, the Pallas kernel in interpret mode), with
    per-lane budgets and hop limits from 1 hop to past convergence."""
    st, ctxs, adj, table, budgets, _ = _walk_problem(kind, 200, 8, 16, 6,
                                                     seed=17)
    hop_limits = np.array([1, 2, 5, 9, 40, 1000], np.int32)
    st_j = tuple(jnp.asarray(a) for a in st)
    ev_j = (jsearch._exact_eval if kind == "exact"
            else jsearch._pq_eval)(jnp.asarray(table))
    args_j = (jnp.asarray(ctxs), jnp.asarray(adj), ev_j, 16,
              jnp.asarray(hop_limits), jnp.asarray(budgets))
    want = jsearch.BeamStepKernel().run_batch(st_j, *args_j)

    class Interpret(jsearch.PallasBeamStep):
        request = "interpret"

    fused = Interpret().run_batch(st_j, *args_j)
    ev_t = (tsearch._exact_eval if kind == "exact"
            else tsearch._pq_eval)(torch.from_numpy(table))
    got = tsearch.run_batch(_to_torch(st), torch.from_numpy(ctxs),
                            torch.from_numpy(adj), ev_t, 16,
                            torch.from_numpy(hop_limits),
                            torch.from_numpy(budgets))
    _assert_same(got, want)
    _assert_same(got, fused)
    assert got[4].numpy().max() > 9                 # some lane walked far
