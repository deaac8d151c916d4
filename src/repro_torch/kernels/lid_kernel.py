"""The batched Hill LID estimate as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/lid_kernel.py::lid_estimate`` (Pallas, TPU).  The
source is ``repro_torch/csrc/lid_kernel.cu``: whole rows a thread, 32
consecutive rows a warp, every 16-byte load of a thread's rows in flight
before their sqrt, log, mean and reciprocal, on a grid of the blocks the
card holds.  The plain version is
:func:`repro_torch.kernels.ref.lid_ref`; the device dispatch lives in
:func:`repro_torch.kernels.ops.lid_estimate`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = _build.Library("lid_kernel", "repro_lid_estimate",
                     [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)

# Kernel launches since the last reset: one per launch, nowhere else.
launches = {"lid_estimate": 0}


def check_args(knn_d2: torch.Tensor) -> tuple[int, int]:
    """The kernel's argument checks (on its tensor's own device): (B, k)."""
    if knn_d2.dim() != 2 or knn_d2.shape[1] < 1:
        raise ValueError(f"lid_estimate takes a (B, k >= 1) matrix, got "
                         f"{tuple(knn_d2.shape)}")
    b, k = knn_d2.shape
    _build.need(knn_d2, "knn_d2", torch.float32, (b, k), knn_d2.device)
    return b, k


def lid_estimate_meta(knn_d2: torch.Tensor) -> torch.Tensor:
    """The kernel's output for a meta input: shapes only, no launch."""
    b, _ = check_args(knn_d2)
    return torch.empty((b,), dtype=torch.float32, device=knn_d2.device)


@_build.on_card
def lid_estimate_cuda(knn_d2: torch.Tensor) -> torch.Tensor:
    """(B, k) ascending squared k-NN distances (float32, on the card) ->
    (B,) LID estimates."""
    dev = knn_d2.device
    _build.check_card(dev, "lid_estimate")
    b, k = check_args(knn_d2)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    rc = LIB.fn()(b, k, knn_d2.data_ptr(), out.data_ptr(), _build.stream(dev))
    if rc != 0:
        raise RuntimeError(f"lid_estimate kernel launch failed: CUDA error "
                           f"{rc}")
    _build.count(launches, "lid_estimate")
    return out
