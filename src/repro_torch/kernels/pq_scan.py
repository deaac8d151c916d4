"""Bulk ADC scan as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/pq_scan.py::pq_scan`` (Pallas, TPU).  The source is
``repro_torch/csrc/pq_scan.cu``: the LUTs of four queries staged in shared
memory as float4 entries, the M byte-indexed lookups of each row summed in m
order (the TPU kernel's one-hot matmul is a workaround for serial gathers
that Hopper does not need).  Where M is a multiple of 16 the lanes of each
quarter-warp run skewed in time, so at every step they look up 8 different
m, which the layout puts in 8 different shared-memory bank groups: no bank
conflict whatever the codes.  Other M take a plain one-row-a-thread kernel.
The plain version is
:func:`repro_torch.kernels.ref.pq_scan_ref`; the device dispatch lives in
:func:`repro_torch.kernels.ops.pq_bulk_scan`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = _build.Library("pq_scan", "repro_pq_scan",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
MAX_K = 256

# Kernel launches since the last reset: one per call that launches the
# kernel, nowhere else.
launches = {"pq_scan": 0}


def check_args(luts: torch.Tensor, codes: torch.Tensor
               ) -> tuple[int, int, int, int]:
    """The kernel's argument checks (on its tensors' own device): (Q, N, M,
    K)."""
    dev = luts.device
    if luts.dim() != 3 or codes.dim() != 2:
        raise ValueError(f"pq_scan takes (Q, M, K) LUTs and (N, M) codes, "
                         f"got {tuple(luts.shape)} and {tuple(codes.shape)}")
    q, m, k = luts.shape
    n = codes.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pq_scan supports 1 <= K <= {MAX_K}, got K={k}")
    _build.need(luts, "luts", torch.float32, (q, m, k), dev)
    _build.need(codes, "codes", torch.uint8, (n, m), dev)
    return q, n, m, k


def pq_scan_meta(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The kernel's output for meta inputs: shapes only, no launch."""
    q, n, _, _ = check_args(luts, codes)
    return torch.empty((q, n), dtype=torch.float32, device=luts.device)


@_build.on_card
def pq_scan_cuda(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) float32 LUTs x (N, M) uint8 codes on the card -> (Q, N)
    float32 ADC distances (codes must lie below K)."""
    dev = luts.device
    _build.check_card(dev, "pq_scan")
    q, n, m, k = check_args(luts, codes)
    if codes.data_ptr() % 16:
        raise ValueError("pq_scan: codes must start on a 16-byte boundary")
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if q == 0 or n == 0:
        return out
    rc = LIB.fn()(q, n, m, k, luts.data_ptr(), codes.data_ptr(),
                  out.data_ptr(), _build.stream(dev))
    if rc != 0:
        raise RuntimeError(f"pq_scan kernel launch failed: CUDA error {rc}")
    _build.count(launches, "pq_scan")
    return out
