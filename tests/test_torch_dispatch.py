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
        kernel.beam_walk_cuda(state, ctxs, adj, table, b, h, kind="exact",
                              max_hops=1)


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
    """``run_batch`` (clone, one ``ops.beam_walk`` to convergence, its
    end-of-walk counter read once) equals stepping ``beam_step_ref`` until
    no lane is active, and leaves its input state untouched."""
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


def _int_walk(kind, n=400, q=9, r=6, width=12, seed=3):
    g = torch.Generator().manual_seed(seed)
    adj = torch.stack([torch.randperm(n, generator=g)[:r]
                       for _ in range(n)]).to(torch.int32)
    adj[torch.rand(adj.shape, generator=g) < 0.1] = -1
    if kind == "exact":
        table = torch.randint(-4, 5, (n, 16), generator=g).float()
        ctxs = torch.randint(-4, 5, (q, 16), generator=g).float()
        ev = search._exact_eval(table)
    else:
        table = torch.randint(0, 16, (n, 4), generator=g).to(torch.uint8)
        ctxs = torch.randint(0, 9, (q, 4, 16), generator=g).float()
        ev = search._pq_eval(table)
    state = search._init_state(ctxs, 7, ev, n, width)
    b = torch.randint(width // 2, width + 1, (q,), generator=g).int()
    h = torch.randint(1, 30, (q,), generator=g).int()
    h[0] = 0                                        # frozen at entry
    return state, ctxs, adj, table, b, h


@pytest.mark.parametrize("kind", ["exact", "pq"])
@pytest.mark.parametrize("max_hops", [1, 5, ops.MAX_HOPS])
def test_beam_walk_equals_iterated_plain_step(kind, max_hops):
    """``ops.beam_walk`` at a hop cap equals ``beam_step_ref`` iterated that
    many times (every lane at once; frozen lanes untouched), counts the
    lanes that can still move, and launches nothing on the CPU."""
    state, ctxs, adj, table, b, h = _int_walk(kind)
    count = torch.zeros((1,), dtype=torch.int32)
    before = ops.launch_counts()
    got = ops.beam_walk(state, ctxs, adj, table, b, h, kind=kind,
                        max_hops=max_hops, active_count=count)
    assert ops.launch_counts() == before
    want, hops = state, 0
    while hops < max_hops and bool(
            ref.lane_active(want[0], want[2], want[4], b, h).any()):
        want = ref.beam_step_ref(want, ctxs, adj, table, b, h, kind=kind)
        hops += 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    left = ref.lane_active(got[0], got[2], got[4], b, h)
    assert int(count) == int(left.sum())
    assert torch.equal(got[4][0], state[4][0])      # the frozen lane
    if max_hops == ops.MAX_HOPS:
        assert int(count) == 0
    else:
        assert int(got[4].max()) <= max_hops


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


def _card_walk(card, kind, n, q, r, width, seed, max_hop_limit=40, dim=None):
    """A walk problem on integer data; ``dim`` is the row width (exact: D,
    default 128; pq: M code bytes over 256 centroids, default 16)."""
    g = torch.Generator().manual_seed(seed)
    adj = torch.stack([torch.randperm(n, generator=g)[:r]
                       for _ in range(n)]).to(torch.int32)
    adj[torch.rand(adj.shape, generator=g) < 0.05] = -1
    if kind == "exact":
        dim = dim or 128
        table = torch.randint(-8, 9, (n, dim), generator=g).float()
        ctxs = torch.randint(-8, 9, (q, dim), generator=g).float()
        ev = search._exact_eval(table)
    else:
        dim = dim or 16
        table = torch.randint(0, 256, (n, dim), generator=g).to(torch.uint8)
        ctxs = torch.randint(0, 64, (q, dim, 256), generator=g).float()
        ev = search._pq_eval(table)
    state = search._init_state(ctxs, 11, ev, n, width)
    b = torch.randint(width // 2, width + 1, (q,), generator=g).int()
    h = torch.randint(1, max_hop_limit + 1, (q,), generator=g).int()
    h[:3] = 0                                       # frozen at entry
    to = lambda t: t.to(card)  # noqa: E731
    return (tuple(map(to, state)), to(ctxs), to(adj), to(table), to(b),
            to(h))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "pq"])
@pytest.mark.parametrize("max_hops", [1, 12, ops.MAX_HOPS])
def test_walk_kernel_matches_plain_on_card(card, kind, max_hops):
    """On the card: one walk launch equals ``beam_step_ref`` iterated, bit
    for bit on integer data (to convergence, at a cap, with lanes frozen at
    entry), counts the lanes left movable, and counts one launch."""
    state, ctxs, adj, table, b, h = _card_walk(card, kind, 5000, 64, 16,
                                               32, seed=5)
    want, left = ref.beam_walk_ref(state, ctxs, adj, table, b, h,
                                   kind=kind, max_hops=max_hops)
    count = torch.zeros((1,), dtype=torch.int32, device=card)
    before = ops.launch_counts()[f"beam_step.{kind}"]
    got = ops.beam_walk(tuple(t.clone() for t in state), ctxs, adj, table,
                        b, h, kind=kind, max_hops=max_hops,
                        active_count=count)
    torch.cuda.synchronize()
    assert ops.launch_counts()[f"beam_step.{kind}"] == before + 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert int(count) == int(left.sum())
    assert torch.equal(got[4][:3], state[4][:3])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_walk_kernel_at_the_candidate_limit_on_card(card, kind):
    """L + R at ``_MAX_CANDIDATES`` (the shared-memory cap of the two
    candidate buffers), to convergence, bit for bit."""
    r = 40
    width = kernel._MAX_CANDIDATES - r
    state, ctxs, adj, table, b, h = _card_walk(card, kind, 3000, 4, r,
                                               width, seed=6,
                                               max_hop_limit=25)
    want, _ = ref.beam_walk_ref(state, ctxs, adj, table, b, h, kind=kind,
                                max_hops=ops.MAX_HOPS)
    got = ops.beam_walk(tuple(t.clone() for t in state), ctxs, adj, table,
                        b, h, kind=kind, max_hops=ops.MAX_HOPS)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    wider = tuple(torch.cat([t, t[:, :1]], 1) if t.shape[1:] == (width,)
                  else t for t in state)            # L + R one past the cap
    with pytest.raises(ValueError):
        kernel.beam_walk_cuda(wider, ctxs, adj, table, b, h, kind=kind,
                              max_hops=1)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,r,dim", [
    ("exact", 96, 960),        # mcgi-gist1m: R = 96, D = 960
    ("exact", 64, 960),        # gist1m-proxy built at degree 64
    ("exact", 40, 3001),       # odd width: 4-byte copies
    ("pq", 64, 128),           # a 128 KB LUT, still in shared memory
    ("pq", 32, 256)])          # a 256 KB LUT, read from global memory
def test_walk_kernel_at_wide_rows_on_card(card, kind, r, dim):
    """Rows wider than one gather round (exact: 48 KB of rows a round) and
    LUTs too large for shared memory walk bit for bit like the plain
    version, to convergence and at a cap."""
    state, ctxs, adj, table, b, h = _card_walk(card, kind, 3000, 40, r, 64,
                                               seed=8, max_hop_limit=30,
                                               dim=dim)
    for max_hops in (5, ops.MAX_HOPS):
        want, left = ref.beam_walk_ref(state, ctxs, adj, table, b, h,
                                       kind=kind, max_hops=max_hops)
        count = torch.zeros((1,), dtype=torch.int32, device=card)
        got = ops.beam_walk(tuple(t.clone() for t in state), ctxs, adj,
                            table, b, h, kind=kind, max_hops=max_hops,
                            active_count=count)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert torch.equal(a, w)
        assert int(count) == int(left.sum())


@pytest.mark.gpu
def test_walk_kernel_refuses_rows_wider_than_shared_memory_on_card(card):
    """An exact row so wide that the query and one row do not fit beside
    the candidates raises ValueError and launches nothing."""
    state, ctxs, adj, table, b, h = _card_walk(card, "exact", 64, 4, 8, 16,
                                               seed=9, dim=40_000)
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        ops.beam_walk(state, ctxs, adj, table, b, h, kind="exact",
                      max_hops=1)
    assert ops.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "pq"])
def test_walk_kernel_takes_an_unsorted_beam_on_card(card, kind):
    """A beam that does not come in sorted (a filter's scrubbed seed, inf
    ahead of finite slots) walks bit for bit like the plain version: its
    first hop takes the general rank merge."""
    state, ctxs, adj, table, b, h = _card_walk(card, kind, 5000, 64, 16,
                                               32, seed=7)
    mid, _ = ref.beam_walk_ref(state, ctxs, adj, table, b, h, kind=kind,
                               max_hops=3)
    ids, d = mid[0].clone(), mid[1].clone()
    ids[:, 0], d[:, 0] = -1, torch.inf               # scrub slot 0
    mid = (ids, d) + tuple(mid[2:])
    want, _ = ref.beam_walk_ref(mid, ctxs, adj, table, b, h, kind=kind,
                                max_hops=ops.MAX_HOPS)
    got = ops.beam_walk(tuple(t.clone() for t in mid), ctxs, adj, table, b,
                        h, kind=kind, max_hops=ops.MAX_HOPS)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
