"""Flash-decoding GQA attention as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (Pallas,
TPU).  The source is ``repro_torch/csrc/decode_attention.cu``: one block of
4 warps per (batch row, KV head, S split); each warp streams its own
16-position tiles through a 3-stage ``cp.async`` ring and computes QK^T and
PV on the tensor cores (bf16 ``mma.sync`` with q and P split into hi + lo
halves, float32 accumulation), the warps combine once at the end, and a
second launch combines the splits in a fixed order.  Any head dim
d % 8 == 0 up to 256 runs; the library picks the split count
(:func:`num_splits`).  The plain version is
:func:`repro_torch.kernels.ref.decode_attention_gqa_ref`; the device
dispatch lives in :func:`repro_torch.kernels.ops.decode_attention`.

kv_len = 0 gives zeros, and kv_len > S counts as S (both as the plain
version does; the TPU kernel would count its zero padding past S as keys).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = _build.Library("decode_attention", "repro_decode_attention",
                     [ctypes.c_int] * 6 + [ctypes.c_void_p] * 9,
                     extra={"repro_decode_attention_splits": [ctypes.c_int] * 4})
MAX_GROUP = 16                # query heads per KV head: the mma's 16 rows
MAX_HEAD_DIM = 256            # any d % 8 == 0 up to this

# Kernel launches since the last reset: one per call that launches the
# kernel (its combine launch included), nowhere else.
launches = {"decode_attention": 0}


def num_splits(b: int, hkv: int, s: int, d: int) -> int:
    """S splits per (batch row, KV head) on the current card: the kernel's
    library chooses them from the occupancy of its split block, as many as
    fill the card's resident block slots in one wave, at least one
    16-position tile each."""
    sp = LIB.fn("repro_decode_attention_splits")(b, hkv, s, d)
    if sp < 1:
        raise RuntimeError(f"decode_attention split query failed: CUDA "
                           f"error {-sp}")
    return sp


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor):
    """The kernel's argument checks (on the cache's own device): (q as
    contiguous float32, kv_len as contiguous int32, (B, S, Hq, Hkv, d))."""
    dev = k.device
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention takes q (B, Hq, d) and k, v "
                         f"(B, S, Hkv, d), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, s, hkv, d = k.shape
    hq = q.shape[1]
    if (hq % hkv or hq // hkv > MAX_GROUP or d % 8 or not 8 <= d <= MAX_HEAD_DIM
            or s < 1):
        raise ValueError(f"decode_attention supports Hq = G * Hkv with "
                         f"G <= {MAX_GROUP}, d % 8 == 0 up to {MAX_HEAD_DIM} "
                         f"and S >= 1; got Hq={hq} Hkv={hkv} d={d} S={s}")
    if k.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention takes a bfloat16 cache on the "
                         f"card, got {k.dtype}")
    if q.device != dev or kv_len.device != dev:
        raise ValueError("decode_attention: q, k, v and kv_len must lie on "
                         "one card")
    if kv_len.dtype.is_floating_point:
        raise ValueError("decode_attention: kv_len must be an integer tensor")
    qf = q.float().contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    _build.need(qf, "q", torch.float32, (b, hq, d), dev)
    _build.need(k, "k", torch.bfloat16, (b, s, hkv, d), dev)
    _build.need(v, "v", torch.bfloat16, (b, s, hkv, d), dev)
    _build.need(lens, "kv_len", torch.int32, (b,), dev)
    return qf, lens, (b, s, hq, hkv, d)


def decode_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """The kernel's output for meta inputs: shapes only, no launch."""
    _, _, (b, _, hq, _, d) = check_args(q, k, v, kv_len)
    return torch.empty((b, hq, d), dtype=torch.float32, device=k.device)


@_build.on_card
def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, d); k, v (B, S, Hkv, d) bfloat16; kv_len (B,) integer, all
    on the card -> (B, Hq, d) float32.  Only a bfloat16 cache, the LM
    path's, is built for the card; the plain version takes any float type
    on the CPU."""
    dev = k.device
    _build.check_card(dev, "decode_attention")
    qf, lens, (b, s, hq, hkv, d) = check_args(q, k, v, kv_len)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v must start on a 16-byte "
                         "boundary")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    splits = num_splits(b, hkv, s, d)
    part_m = torch.empty((b, hq, splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hq, splits, d), dtype=torch.float32,
                           device=dev)
    rc = LIB.fn()(b, hq, hkv, s, d, splits, qf.data_ptr(), k.data_ptr(),
                  v.data_ptr(), lens.data_ptr(), part_m.data_ptr(),
                  part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                  _build.stream(dev))
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    _build.count(launches, "decode_attention")
    return out
