"""The batched beam walk as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/beam_step.py::beam_step`` (Pallas, TPU), which
advances every lane by one hop per call.  The source is
``repro_torch/csrc/beam_step.cu``; it says what bounds the kernel on the
card and how its design answers that: one block per lane keeps the lane's
beam in shared memory and walks up to ``max_hops`` hops in one launch, each
lane until it freezes.  :mod:`repro_torch.kernels._build` compiles it for
``sm_90a`` at first use and loads its plain C interface with ``ctypes``.

:func:`beam_walk_cuda` updates the walk state **in place**: every state
tensor must be contiguous and on the card, and after the call holds the
state after the walk (lanes frozen at entry untouched).
``ops.beam_step`` is the same kernel at ``max_hops = 1``.
:func:`beam_hop_rows_cuda` is the out-of-core walk's hop: one hop of every
lane with its adjacency row supplied (kind "pq"), then the next frontier's
select, counted as ``pq_rows``.  Rows of any
width walk: "exact" gathers its neighbour rows in rounds of at most 48 KB,
and "pq" reads a LUT too large for shared memory from global memory.  The
one limit is that the two candidate buffers, the exact query and one exact
row fit in a block's shared memory (about 28,000 floats a row at small
L + R); past it the C entry point launches nothing and the wrapper raises
``ValueError``.  The plain
version is :func:`repro_torch.kernels.ref.beam_step_ref`, iterated; the
device dispatch lives in :func:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_KINDS = {"exact": 0, "pq": 1}
# L + R: the two candidate buffers (9 bytes a candidate each) stay < 96 KB.
_MAX_CANDIDATES = 5000
MAX_HOPS = 2**31 - 1          # a hop cap that never binds: walk to the end
_TOO_WIDE = -2                # csrc: kTooWide, nothing launched

LIB = _build.Library("beam_step", "repro_beam_walk",
                     [ctypes.c_int] * 9 + [ctypes.c_void_p] * 13,
                     extra={"repro_beam_hop_rows":
                            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 16})

# Kernel launches since the last reset, per kind (``pq_rows``: the row-fed
# hop): one per launch, nowhere else.
launches = {"exact": 0, "pq": 0, "pq_rows": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def check_walk_args(state, ctxs, adj, table, *, kind, max_hops: int,
                    active_count: torch.Tensor | None = None):
    """The walk kernel's argument checks (on the state's own device):
    (Q, L, R, N, words, dim, K)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown beam_step kind {kind!r}")
    if not 0 <= max_hops <= MAX_HOPS:
        raise ValueError(f"max_hops must lie in [0, {MAX_HOPS}], got "
                         f"{max_hops}")
    beam_ids, beam_d, beam_exp, visited, hops, evals = state
    dev = beam_ids.device
    q, width = beam_ids.shape
    r = adj.shape[1]
    if width + r > _MAX_CANDIDATES:
        raise ValueError(f"beam width + degree = {width + r} exceeds "
                         f"{_MAX_CANDIDATES}")
    n = table.shape[0]
    nw = (n + 31) // 32
    _build.need(beam_ids, "beam_ids", torch.int32, (q, width), dev)
    _build.need(beam_d, "beam_d", torch.float32, (q, width), dev)
    _build.need(beam_exp, "beam_exp", torch.bool, (q, width), dev)
    _build.need(visited, "visited", torch.int32, (q, nw), dev)
    _build.need(hops, "hops", torch.int32, (q,), dev)
    _build.need(evals, "evals", torch.int32, (q,), dev)
    _build.need(adj, "adj", torch.int32, (adj.shape[0], r), dev)
    dim = table.shape[1]
    if kind == "exact":
        k = 0
        _build.need(table, "table", torch.float32, (n, dim), dev)
        _build.need(ctxs, "ctxs", torch.float32, (q, dim), dev)
    else:
        k = ctxs.shape[-1]
        _build.need(table, "table", torch.uint8, (n, dim), dev)
        _build.need(ctxs, "ctxs", torch.float32, (q, dim, k), dev)
    if active_count is not None:
        _build.need(active_count, "active_count", torch.int32, (1,), dev)
    return q, width, r, n, nw, dim, k


@_build.on_card
def beam_walk_cuda(state, ctxs, adj, table, budgets, hop_limits, *, kind,
                   max_hops: int, active_count: torch.Tensor | None = None):
    """Walk every lane of ``state`` on the card, in place, until it freezes
    or has taken ``max_hops`` hops in this call.

    Shapes and dtypes as :func:`repro_torch.kernels.ref.beam_step_ref`;
    ``budgets``/``hop_limits`` are (Q,) int32 (or broadcastable scalars).
    ``active_count`` (one int32 on the card, optional) gains one for every
    lane that can still move after the walk.  Returns ``state``.
    """
    beam_ids, beam_d, beam_exp, visited, hops, evals = state
    dev = beam_ids.device
    _build.check_card(dev, "beam_step")
    q, width, r, n, nw, dim, k = check_walk_args(
        state, ctxs, adj, table, kind=kind, max_hops=max_hops,
        active_count=active_count)
    budgets = torch.as_tensor(budgets, dtype=torch.int32, device=dev)
    budgets = budgets.expand(q).contiguous()
    hop_limits = torch.as_tensor(hop_limits, dtype=torch.int32, device=dev)
    hop_limits = hop_limits.expand(q).contiguous()
    if kind == "exact":
        vec4 = int(dim % 4 == 0 and table.data_ptr() % 16 == 0
                   and ctxs.data_ptr() % 16 == 0)
    else:
        vec4 = int(dim * k % 4 == 0 and ctxs.data_ptr() % 16 == 0)
    fn = LIB.fn()
    rc = fn(_KINDS[kind], q, width, r, nw, dim, k, vec4, max_hops,
            beam_ids.data_ptr(), beam_d.data_ptr(), beam_exp.data_ptr(),
            visited.data_ptr(), hops.data_ptr(), evals.data_ptr(),
            ctxs.data_ptr(), adj.data_ptr(), table.data_ptr(),
            budgets.data_ptr(), hop_limits.data_ptr(),
            active_count.data_ptr() if active_count is not None else None,
            _build.stream(dev))
    if rc == _TOO_WIDE:
        raise ValueError(f"beam_step[{kind}]: the two candidate buffers "
                         f"(L + R = {width + r}), the query and one row of "
                         f"width {dim} do not fit in a block's shared "
                         f"memory")
    if rc != 0:
        raise RuntimeError(f"beam_step kernel launch failed: CUDA error {rc}")
    _build.count(launches, kind)
    return state



def check_hop_rows_args(state, u, active, rows, ctxs, table, *, kind):
    """The row-fed hop's argument checks (on the state's own device):
    (Q, L, R, words, M, K); R, M and K are 0 for the select alone."""
    if kind != "pq":
        raise ValueError(f"the row-fed hop takes kind 'pq' only, got {kind!r}")
    beam_ids, beam_d, beam_exp, visited, hops, evals = state
    dev = beam_ids.device
    q, width = beam_ids.shape
    nw = visited.shape[1]
    _build.need(beam_ids, "beam_ids", torch.int32, (q, width), dev)
    _build.need(beam_d, "beam_d", torch.float32, (q, width), dev)
    _build.need(beam_exp, "beam_exp", torch.bool, (q, width), dev)
    _build.need(visited, "visited", torch.int32, (q, nw), dev)
    _build.need(hops, "hops", torch.int32, (q,), dev)
    _build.need(evals, "evals", torch.int32, (q,), dev)
    r = m = k = 0
    if active is not None:
        r, m, k = rows.shape[1], table.shape[1], ctxs.shape[-1]
        if width + r > _MAX_CANDIDATES:
            raise ValueError(f"beam width + degree = {width + r} exceeds "
                             f"{_MAX_CANDIDATES}")
        _build.need(u, "u", torch.int32, (q,), dev)
        _build.need(active, "active", torch.bool, (q,), dev)
        _build.need(rows, "rows", torch.int32, (q, r), dev)
        _build.need(ctxs, "ctxs", torch.float32, (q, m, k), dev)
        _build.need(table, "table", torch.uint8, (table.shape[0], m), dev)
    return q, width, r, nw, m, k


@_build.on_card
def beam_hop_rows_cuda(state, u, active, rows, ctxs, table, budgets,
                       hop_limits, *, kind):
    """One row-fed hop of every lane on the card, in place (semantics of
    :func:`repro_torch.kernels.ref.beam_hop_rows_ref`; kind "pq" only).

    ``u`` (Q,) int32 and ``active`` (Q,) bool are each lane's selected
    frontier and whether it moves; ``rows`` (Q, R) int32 its adjacency row;
    ``ctxs`` (Q, M, K) float32 LUTs and ``table`` (N, M) uint8 codes.
    ``active=None`` is the select alone (``u``, ``rows``, ``ctxs`` and
    ``table`` unused; only ``beam_exp`` is written).  Returns
    ``(state, u_next, active_next)``, the last two new (Q,) tensors.
    """
    beam_ids, beam_d, beam_exp, visited, hops, evals = state
    dev = beam_ids.device
    _build.check_card(dev, "beam_step")
    q, width, r, nw, m, k = check_hop_rows_args(state, u, active, rows, ctxs,
                                                table, kind=kind)
    budgets = torch.as_tensor(budgets, dtype=torch.int32, device=dev)
    budgets = budgets.expand(q).contiguous()
    hop_limits = torch.as_tensor(hop_limits, dtype=torch.int32, device=dev)
    hop_limits = hop_limits.expand(q).contiguous()
    ptrs = [None] * 5
    if active is not None:
        ptrs = [t.data_ptr() for t in (u, active, rows, ctxs, table)]
    u_next = torch.empty((q,), dtype=torch.int32, device=dev)
    active_next = torch.empty((q,), dtype=torch.bool, device=dev)
    rc = LIB.fn("repro_beam_hop_rows")(
        q, width, r, nw, m, k, beam_ids.data_ptr(),
        beam_d.data_ptr(), beam_exp.data_ptr(), visited.data_ptr(),
        hops.data_ptr(), evals.data_ptr(), *ptrs, budgets.data_ptr(),
        hop_limits.data_ptr(), u_next.data_ptr(), active_next.data_ptr(),
        _build.stream(dev))
    if rc == _TOO_WIDE:
        raise ValueError(f"beam_step[pq_rows]: the two candidate buffers "
                         f"(L + R = {width + r}) do not fit in a block's "
                         f"shared memory")
    if rc != 0:
        raise RuntimeError(f"beam_step row-fed hop launch failed: CUDA error "
                           f"{rc}")
    _build.count(launches, "pq_rows")
    return state, u_next, active_next
