"""k smallest entries per row as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/topk.py::topk`` (Pallas, TPU).  The source is
``repro_torch/csrc/topk.cu``: one pass over the matrix, one compare per
element against the k-th of the best k so far, the few that pass collected
in shared memory and compacted by a sort on (value, id); rows too short to
fill the card are cut into segments whose partial lists a second launch
merges.  The plain version is :func:`repro_torch.kernels.ref.topk_ref`; the
device dispatch lives in :func:`repro_torch.kernels.ops.topk`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = _build.Library("topk", "repro_topk",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
MAX_K = 64
_TARGET_BLOCKS = 4 * 132      # about four blocks per SM of an H100
_MIN_SEGMENT = 2048

# Kernel launches since the last reset: one per call that launches the
# kernel (a segmented call's merge launch included), nowhere else.
launches = {"topk": 0}


def check_k(k: int, n: int) -> None:
    """The bounds both versions enforce: 1 <= k <= min(64, N)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk supports 1 <= k <= {MAX_K}, got k={k}")
    if k > n:
        raise ValueError(f"topk: k={k} exceeds the row length {n}")


def segment_length(q: int, n: int) -> int:
    """Columns per block: a whole row when there are rows enough to fill
    the card, else segments of at least ``_MIN_SEGMENT`` columns."""
    want = -(-_TARGET_BLOCKS // max(q, 1))
    segs = max(1, min(want, n // _MIN_SEGMENT))
    return -(-n // segs)


def topk_cuda(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) float32 on the card -> ((Q, k) ascending values, (Q, k) int32
    ids); ties go to the lower id."""
    dev = d.device
    _build.check_card(dev, "topk")
    if d.dim() != 2:
        raise ValueError(f"topk takes a (Q, N) matrix, got {tuple(d.shape)}")
    q, n = d.shape
    check_k(k, n)
    _build.need(d, "d", torch.float32, (q, n), dev)
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_v, out_i
    seg = segment_length(q, n)
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
    launches["topk"] += 1
    return out_v, out_i
