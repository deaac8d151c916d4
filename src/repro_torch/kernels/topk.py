"""k smallest entries per row as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/topk.py::topk`` (Pallas, TPU) for any
1 <= k <= N.  The source is ``repro_torch/csrc/topk.cu``.  For k <= 256 it
is a warp-select with no block barrier: one warp streams a row, or a
segment of one, with 16-byte loads, compares each element with the k-th of
its best so far, appends the few that pass to a warp-private buffer (slots
from ``__ballot_sync``) and merges a full buffer into its sorted best (64,
128 or 256 keys, the smallest list that holds k) by a bitonic network in
registers on (value, id).  Rows are cut into segments only when they alone
would leave the card's resident warps idle (:func:`segment_length`); a
second launch merges the segments' lists.  For larger k one launch of a
radix select (a block a row) takes the k entries in column order and a
stable sort on the value orders them, as the reference's ``topk`` merges
its tiles outside its kernel.  The plain version is
:func:`repro_torch.kernels.ref.topk_ref`; the device dispatch lives in
:func:`repro_torch.kernels.ops.topk`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = _build.Library("topk", "repro_topk",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6,
                     extra={"repro_topk_warp_slots": [ctypes.c_int]})
_MIN_SEGMENT = 4096           # columns a segment's warp streams at least

# Kernel launches since the last reset: one per call that launches the
# kernel (a segmented call's merge launch included), nowhere else.
launches = {"topk": 0}


def check_k(k: int, n: int) -> None:
    """The bounds both versions enforce, the reference's: 1 <= k <= N."""
    if k < 1:
        raise ValueError(f"topk needs k >= 1, got k={k}")
    if k > n:
        raise ValueError(f"topk: k={k} exceeds the row length {n}")


def segment_length(q: int, n: int, slots: int) -> int:
    """Columns per warp: a whole row when the ``q`` rows alone fill the
    card's ``slots`` resident warps, else as many segments a row as keep
    every segment's warp in one wave, each of at least ``_MIN_SEGMENT``
    columns."""
    segs = max(1, min(slots // max(q, 1), n // _MIN_SEGMENT))
    return -(-n // segs)


def warp_slots(k: int) -> int:
    """Warps of the warp-select for ``k`` (its list size) the current card
    holds at once (the occupancy calculator's count, from the library); 0
    where k is past the warp-select's largest list, for the radix
    select."""
    slots = LIB.fn("repro_topk_warp_slots")(k)
    if slots < 0:
        raise RuntimeError(f"topk: occupancy query failed: CUDA error "
                           f"{-slots}")
    return slots


def check_args(d: torch.Tensor, k: int) -> tuple[int, int]:
    """The kernel's argument checks (on its tensor's own device): (Q, N)."""
    if d.dim() != 2:
        raise ValueError(f"topk takes a (Q, N) matrix, got {tuple(d.shape)}")
    q, n = d.shape
    check_k(k, n)
    _build.need(d, "d", torch.float32, (q, n), d.device)
    return q, n


def topk_meta(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's outputs for a meta input: shapes only, no launch."""
    q, _ = check_args(d, k)
    return (torch.empty((q, k), dtype=torch.float32, device=d.device),
            torch.empty((q, k), dtype=torch.int32, device=d.device))


@_build.on_card
def topk_cuda(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) float32 on the card -> ((Q, k) ascending values, (Q, k) int32
    ids); ties go to the lower id."""
    dev = d.device
    _build.check_card(dev, "topk")
    q, n = check_args(d, k)
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_v, out_i
    slots = warp_slots(k)
    if slots == 0:
        # One launch takes the k entries in column order; a stable sort on
        # the value then gives (value, id) order.
        rc = LIB.fn()(q, n, k, n, d.data_ptr(), out_v.data_ptr(),
                      out_i.data_ptr(), None, None, _build.stream(dev))
        if rc != 0:
            raise RuntimeError(f"topk kernel launch failed: CUDA error {rc}")
        _build.count(launches, "topk")
        order = torch.argsort(out_v, dim=1, stable=True)
        return torch.gather(out_v, 1, order), torch.gather(out_i, 1, order)
    seg = segment_length(q, n, slots)
    segs = -(-n // seg)
    part_v = part_i = None
    if segs > 1:
        part_v = torch.empty((q, segs, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((q, segs, k), dtype=torch.int32, device=dev)
    rc = LIB.fn()(q, n, k, seg, d.data_ptr(), out_v.data_ptr(),
                  out_i.data_ptr(),
                  None if part_v is None else part_v.data_ptr(),
                  None if part_i is None else part_i.data_ptr(),
                  _build.stream(dev))
    if rc != 0:
        raise RuntimeError(f"topk kernel launch failed: CUDA error {rc}")
    _build.count(launches, "topk")
    return out_v, out_i
