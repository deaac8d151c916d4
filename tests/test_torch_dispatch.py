"""Kernel dispatch in the port: by the tensors' device only, never a
fallback from the kernel to the plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.kernels import beam_step as kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)


def _problem(device="cpu", q=3, n=96, r=6, width=8, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    adj = torch.stack([torch.randperm(n, generator=g)[:r]
                       for _ in range(n)]).to(torch.int32)
    table = torch.randint(-4, 5, (n, d), generator=g).float()
    ctxs = torch.randint(-4, 5, (q, d), generator=g).float()
    state = search._init_state(ctxs, 5, search._exact_eval(table), n, width)
    move = lambda t: t.to(device)  # noqa: E731
    return (tuple(map(move, state)), move(ctxs), move(adj), move(table),
            move(torch.full((q,), width, dtype=torch.int32)),
            move(torch.full((q,), 4, dtype=torch.int32)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cpu_tensor_runs_plain_version():
    state, ctxs, adj, table, b, h = _problem()
    before = ops.launch_counts()
    got = ops.beam_step(state, ctxs, adj, table, b, h, kind="exact")
    want = ref.beam_step_ref(state, ctxs, adj, table, b, h, kind="exact")
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert ops.launch_counts() == before      # no kernel launch counted


def test_other_device_raises():
    state, ctxs, adj, table, b, h = _problem(device="meta")
    with pytest.raises(ValueError):
        ops.beam_step(state, ctxs, adj, table, b, h, kind="exact")


def test_kernel_request_without_card_raises():
    """Asking the CUDA kernel for CPU tensors raises; it never hands back
    the plain version."""
    state, ctxs, adj, table, b, h = _problem()
    with pytest.raises(ValueError):
        kernel.beam_step_cuda(state, ctxs, adj, table, b, h, kind="exact")


def test_cuda_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device()          # the default is the card


def test_step_kernel_defaults_follow_the_device():
    """The hop loop has one hop, ``ops.beam_step``: CPU tensors walk through
    its plain version (no launch counted); an evaluator whose table the
    step cannot read raises instead of walking some other way."""
    state, ctxs, adj, table, b, h = _problem()
    before = ops.launch_counts()
    search.run_batch(state, ctxs, adj, search._exact_eval(table), 8, h, b)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="evaluator"):
        search.run_batch(state, ctxs, adj, lambda c, i, v: c[:, :1], 8, h, b)


@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_hop_loop_equals_hop_by_hop_plain_version(kind):
    """``run_batch`` (clone, counter polled every POLL_HOPS hops) equals
    stepping ``beam_step_ref`` until no lane is active, and leaves its
    input state untouched."""
    g = torch.Generator().manual_seed(3)
    n, q, r, width = 400, 9, 6, 12
    adj = torch.stack([torch.randperm(n, generator=g)[:r]
                       for _ in range(n)]).to(torch.int32)
    if kind == "exact":
        table = torch.randint(-4, 5, (n, 16), generator=g).float()
        ctxs = torch.randint(-4, 5, (q, 16), generator=g).float()
        ev = search._exact_eval(table)
    else:
        table = torch.randint(0, 16, (n, 4), generator=g).to(torch.uint8)
        ctxs = torch.randint(0, 9, (q, 4, 16), generator=g).float()
        ev = search._pq_eval(table)
    state = search._init_state(ctxs, 7, ev, n, width)
    keep = tuple(t.clone() for t in state)
    b = torch.randint(width // 2, width + 1, (q,), generator=g).int()
    h = torch.randint(1, 30, (q,), generator=g).int()
    got = search.run_batch(state, ctxs, adj, ev, width, h, b)
    want = state
    while bool(ref.lane_active(want[0], want[2], want[4], b, h).any()):
        want = ref.beam_step_ref(want, ctxs, adj, table, b, h, kind=kind)
    for a, w, k in zip(got, want, keep):
        assert torch.equal(a, w)
    for s_, k in zip(state, keep):
        assert torch.equal(s_, k)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_kernel_matches_plain_on_card(card, kind):
    """On the card: the CUDA kernel equals the plain version bit for bit on
    integer data, hop after hop, and counts its launches."""
    g = torch.Generator().manual_seed(1)
    n, q, r, width = 5000, 64, 16, 32
    adj = torch.stack([torch.randperm(n, generator=g)[:r]
                       for _ in range(n)]).to(torch.int32)
    if kind == "exact":
        table = torch.randint(-8, 9, (n, 128), generator=g).float()
        ctxs = torch.randint(-8, 9, (q, 128), generator=g).float()
        ev = search._exact_eval(table)
    else:
        table = torch.randint(0, 256, (n, 16), generator=g).to(torch.uint8)
        ctxs = torch.randint(0, 64, (q, 16, 256), generator=g).float()
        ev = search._pq_eval(table)
    state = search._init_state(ctxs, 11, ev, n, width)
    b = torch.randint(width // 2, width + 1, (q,), generator=g).int()
    h = torch.randint(2, 13, (q,), generator=g).int()
    args = [t.to(card) for t in (ctxs, adj, table, b, h)]
    st_k = tuple(t.to(card) for t in state)
    st_p = st_k
    before = ops.launch_counts()[f"beam_step.{kind}"]
    for _ in range(12):
        st_k = ops.beam_step(tuple(t.clone() for t in st_k), *args, kind=kind)
        st_p = ref.beam_step_ref(st_p, *args, kind=kind)
        for a, w in zip(st_k, st_p):
            assert torch.equal(a, w)
    assert ops.launch_counts()[f"beam_step.{kind}"] == before + 12
    assert np.all(st_p[4].cpu().numpy() <= h.numpy())
