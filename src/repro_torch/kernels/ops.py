"""Device-dispatching wrappers for the port's kernels.

Dispatch is by the tensors' device only: a tensor on the CPU runs the plain
PyTorch version (:mod:`repro_torch.kernels.ref`); a tensor on a CUDA device
launches the hand-written kernel, which raises if it cannot build or launch
or the card is not sm_90.  Nothing falls back from the kernel to the plain
version.  Library code calls these wrappers only.

Inside :func:`shapes_only` a tensor on the ``meta`` device takes each
kernel's shape function (``*_meta`` beside each ``*_cuda``; the walk's
argument checks for ``beam_step``): the checks the CUDA wrapper makes,
then ``torch.empty`` outputs of the kernel's shapes and dtypes (the walk
returns its state, which it would update in place).  It computes nothing
and counts no launch; it counts the call in :func:`shape_calls` instead.
Outside that mode a meta tensor raises, as any device other than the
card and the CPU does.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import beam_step as _beam
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import l2_distance as _l2
from repro_torch.kernels import lid_kernel as _lid
from repro_torch.kernels import pq_scan as _pq
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import topk as _topk

# A walk's hop cap that never binds (the walk runs to convergence).
MAX_HOPS = _beam.MAX_HOPS
# Every kernel library of the port (``_build.build_all`` compiles them at once).
LIBRARIES = (_beam.LIB, _l2.LIB, _topk.LIB, _lid.LIB, _pq.LIB, _da.LIB)
# The modules whose ``launches`` dict counts one kernel each.
_COUNTED = (_l2, _topk, _lid, _pq, _da)


# Kernel calls answered by shape functions since the last reset (the dry
# run's record of the kernels a step reached; never a launch).
_shape_calls: dict[str, int] = {}
_shapes_only = 0


@contextlib.contextmanager
def shapes_only():
    """Let the wrappers take meta tensors (shapes only) inside the block."""
    global _shapes_only
    _shapes_only += 1
    try:
        yield
    finally:
        _shapes_only -= 1


def shape_calls() -> dict[str, int]:
    """Calls per kernel answered on the meta device (not launches)."""
    return dict(_shape_calls)


def reset_shape_calls() -> None:
    _shape_calls.clear()


def _device(t: torch.Tensor, op: str) -> torch.device:
    kind = t.device.type
    if kind == "meta" and _shapes_only:
        _shape_calls[op] = _shape_calls.get(op, 0) + 1
    elif kind not in ("cuda", "cpu"):
        raise ValueError(f"{op} has no implementation for device {t.device}")
    return t.device


def bulk_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) float32 squared L2 (float32 or bfloat16
    operands, accumulated in float32)."""
    kind = _device(q, "l2_distance").type
    if kind == "cuda":
        return _l2.l2_distance_cuda(q, x)
    if kind == "meta":
        return _l2.l2_distance_meta(q, x)
    return _ref.l2_distance_ref(q, x)


def _topk_forward(d: torch.Tensor, k: int):
    kind = _device(d, "topk").type
    if kind == "cuda":
        return _topk.topk_cuda(d, k)
    if kind == "meta":
        return _topk.topk_meta(d, k)
    _topk.check_k(k, d.shape[1])
    return _ref.topk_ref(d, k)


class _TopK(torch.autograd.Function):
    """The kernel (or ``topk_ref`` on the CPU) as the forward; the values'
    gradient scattered back to their ids as the backward (``lax.top_k``'s
    VJP, outside any kernel in the reference too).  The ids get none."""

    @staticmethod
    def forward(ctx, d, k):
        vals, ids = _topk_forward(d, k)
        ctx.save_for_backward(ids)
        ctx.shape = d.shape
        ctx.mark_non_differentiable(ids)
        return vals, ids

    @staticmethod
    def backward(ctx, g_vals, _g_ids):
        (ids,) = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g_vals.dtype,
                           device=g_vals.device)
        return grad.scatter_add_(1, ids.long(), g_vals), None


def topk(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) -> ((Q, k) ascending values, (Q, k) int32 ids), ties to the
    lower id; any 1 <= k <= N on every device.  Where autograd records
    (``d`` requires grad), the values carry a gradient to ``d`` on every
    device (the MoE router trains through them); elsewhere the kernel is
    called directly."""
    if torch.is_grad_enabled() and d.requires_grad:
        return _TopK.apply(d, k)
    return _topk_forward(d, k)


def lid_estimate(knn_d2: torch.Tensor) -> torch.Tensor:
    """(B, k) ascending squared k-NN distances -> (B,) Hill LID."""
    kind = _device(knn_d2, "lid_estimate").type
    if kind == "cuda":
        return _lid.lid_estimate_cuda(knn_d2)
    if kind == "meta":
        return _lid.lid_estimate_meta(knn_d2)
    return _ref.lid_ref(knn_d2)


def pq_bulk_scan(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) float32 LUTs x (N, M) uint8 codes -> (Q, N) ADC distances,
    summed in m order."""
    kind = _device(luts, "pq_scan").type
    if kind == "cuda":
        return _pq.pq_scan_cuda(luts, codes)
    if kind == "meta":
        return _pq.pq_scan_meta(luts, codes)
    return _ref.pq_scan_ref(luts, codes)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Flash-decoding GQA attention: q (B, Hq, d) against k, v
    (B, S, Hkv, d) masked at kv_len (B,) -> (B, Hq, d) float32; kv_len = 0
    gives zeros and kv_len > S counts as S on every device."""
    kind = _device(k, "decode_attention").type
    if kind == "cuda":
        return _da.decode_attention_cuda(q, k, v, kv_len)
    if kind == "meta":
        return _da.decode_attention_meta(q, k, v, kv_len)
    return _ref.decode_attention_gqa_ref(q, k, v, kv_len)


def beam_step(state, ctxs, adj, table, budgets, hop_limits, *, kind: str,
              active_count: torch.Tensor | None = None):
    """One fused hop of the batched beam walk (state layout as in
    :func:`repro_torch.kernels.ref.beam_step_ref`): :func:`beam_walk` at
    ``max_hops = 1``."""
    return beam_walk(state, ctxs, adj, table, budgets, hop_limits, kind=kind,
                     max_hops=1, active_count=active_count)


def beam_walk(state, ctxs, adj, table, budgets, hop_limits, *, kind: str,
              max_hops: int, active_count: torch.Tensor | None = None):
    """Walk every lane until it freezes (hop limit reached or frontier
    closed) or ``max_hops`` hops are taken in this call (``MAX_HOPS``: no
    cap); one kernel launch on the card.

    On the card the state is updated in place and returned; on the CPU
    :func:`repro_torch.kernels.ref.beam_walk_ref` returns a new state.
    Callers use the return value either way.  ``active_count`` (one int32,
    optional) gains one for each lane that can still move after the walk.
    """
    dev = _device(state[0], f"beam_step.{kind}")
    if dev.type == "cuda":
        return _beam.beam_walk_cuda(state, ctxs, adj, table, budgets,
                                    hop_limits, kind=kind, max_hops=max_hops,
                                    active_count=active_count)
    if dev.type == "meta":
        _beam.check_walk_args(state, ctxs, adj, table, kind=kind,
                              max_hops=max_hops, active_count=active_count)
        return state
    out, active = _ref.beam_walk_ref(state, ctxs, adj, table, budgets,
                                     hop_limits, kind=kind,
                                     max_hops=max_hops)
    if active_count is not None:
        active_count += active.sum(dtype=torch.int32)
    return out


def beam_hop_rows(state, u, active, rows, ctxs, table, budgets, hop_limits,
                  *, kind: str):
    """One hop of the out-of-core walk: each ``active`` lane expands its
    selected frontier ``u`` with its adjacency row ``rows`` (Q, R), then
    every lane that can move selects and marks its next frontier; returns
    ``(state, u_next, active_next)`` (see
    :func:`repro_torch.kernels.ref.beam_hop_rows_ref`).  ``active=None`` is
    the select alone.  Kind "pq" only; one launch of the row-fed kernel on
    the card (the state updated in place), the plain version on the CPU
    (new tensors).  Callers use the return value either way."""
    if kind != "pq":
        raise ValueError(f"the row-fed hop takes kind 'pq' only, got {kind!r}")
    dev = _device(state[0], "beam_step.pq_rows")
    if dev.type == "cuda":
        return _beam.beam_hop_rows_cuda(state, u, active, rows, ctxs, table,
                                        budgets, hop_limits, kind=kind)
    if dev.type == "meta":
        q = _beam.check_hop_rows_args(state, u, active, rows, ctxs, table,
                                      kind=kind)[0]
        return (state, torch.empty((q,), dtype=torch.int32, device=dev),
                torch.empty((q,), dtype=torch.bool, device=dev))
    return _ref.beam_hop_rows_ref(state, u, active, rows, ctxs, table,
                                  budgets, hop_limits, kind=kind)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last :func:`reset_launch_counts`:
    ``beam_step.exact``, ``beam_step.pq``, ``beam_step.pq_rows`` (the
    out-of-core walk's row-fed hop), ``l2_distance``, ``topk``,
    ``lid_estimate``, ``pq_scan`` and ``decode_attention``."""
    out = {f"beam_step.{k}": v for k, v in _beam.launches.items()}
    for mod in _COUNTED:
        out.update(mod.launches)
    return out


def reset_launch_counts() -> None:
    _beam.reset_launch_counts()
    for mod in _COUNTED:
        for k in mod.launches:
            mod.launches[k] = 0
