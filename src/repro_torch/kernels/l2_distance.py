"""The squared-L2 distance matrix as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/l2_distance.py::l2_distance`` (Pallas, TPU).  The
source is ``repro_torch/csrc/l2_distance.cu``: the cross term on the
tensor cores, float32 operands as three TF32 products on ``wgmma`` (each
operand split into a TF32 big and a TF32 small part, a partial per slice of
32 along D: float32 accuracy, and integer inputs with |v| <= 2048 exact),
bfloat16 operands as one ``mma.sync`` bf16 product; persistent blocks stream
both operand tiles through a ``cp.async`` ring, and a first launch sums the
float32 norms into a scratch the wrapper allocates.  The plain version is
:func:`repro_torch.kernels.ref.l2_distance_ref`; the device dispatch lives in
:func:`repro_torch.kernels.ops.bulk_l2`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = _build.Library("l2_distance", "repro_l2_distance",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: one per launch, nowhere else.
launches = {"l2_distance": 0}


def check_args(q: torch.Tensor, x: torch.Tensor) -> tuple[int, int]:
    """The kernel's argument checks (on its tensors' own device): (Q, N)."""
    dev = q.device
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"l2_distance: shapes {tuple(q.shape)} and "
                         f"{tuple(x.shape)} are not (Q, D) and (N, D)")
    if q.dtype not in _DTYPES or x.dtype != q.dtype:
        raise ValueError(f"l2_distance takes float32 or bfloat16 operands of "
                         f"one type, got {q.dtype} and {x.dtype}")
    nq, d = q.shape
    _build.need(q, "q", q.dtype, (nq, d), dev)
    _build.need(x, "x", q.dtype, (x.shape[0], d), dev)
    return nq, x.shape[0]


def l2_distance_meta(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's output for meta operands: shapes only, no launch."""
    nq, n = check_args(q, x)
    return torch.empty((nq, n), dtype=torch.float32, device=q.device)


@_build.on_card
def l2_distance_cuda(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) float32 squared L2 on the card.  Both
    operands float32, or both bfloat16 (accumulated in float32)."""
    dev = q.device
    _build.check_card(dev, "l2_distance")
    nq, n = check_args(q, x)
    d = q.shape[1]
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0:
        return out
    norms = torch.empty(nq + n, dtype=torch.float32, device=dev)  # scratch
    rc = LIB.fn()(_DTYPES[q.dtype], nq, n, d, q.data_ptr(), x.data_ptr(),
                  norms.data_ptr(), out.data_ptr(), _build.stream(dev))
    if rc != 0:
        raise RuntimeError(f"l2_distance kernel launch failed: CUDA error {rc}")
    _build.count(launches, "l2_distance")
    return out
