"""The fused beam-walk hop as a hand-written CUDA kernel for Hopper.

Replaces ``repro/kernels/beam_step.py::beam_step`` (Pallas, TPU).  The source
is ``repro_torch/csrc/beam_step.cu``; it says what bounds the kernel on the
card and how its design answers that.  It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use (into
``build/`` at the repository root, named by the source's hash) and loaded
with ``ctypes``.

:func:`beam_step_cuda` updates the walk state **in place**: every state
tensor must be contiguous and on the card, and after the call holds the
post-hop state (frozen lanes untouched).  The plain version is
:func:`repro_torch.kernels.ref.beam_step_ref`; the device dispatch lives in
:func:`repro_torch.kernels.ops.beam_step`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "beam_step.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_KINDS = {"exact": 0, "pq": 1}
_MAX_CANDIDATES = 5000        # L + R: the merge's shared memory stays < 48 KB

# Kernel launches since the last reset, per kind: one per launch, nowhere else.
launches = {"exact": 0, "pq": 0}

_lock = threading.Lock()
_fn = None
# nvcc's report (registers, shared memory, spills) from the last build here.
build_log = ""


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the beam_step kernel is compiled "
                       "from source on the machine with the card")


def library_path() -> pathlib.Path:
    """Build the kernel library if it is not built yet; return its path."""
    src = _SRC.read_bytes()
    out = _BUILD_DIR / f"beam_step-{hashlib.sha1(src).hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    global build_log
    build_log = proc.stderr
    os.replace(tmp, out)
    return out


def _library():
    global _fn
    with _lock:
        if _fn is None:
            lib = ctypes.CDLL(str(library_path()))
            fn = lib.repro_beam_step
            fn.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_void_p] * 13)
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def _check_card(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"beam_step_cuda needs tensors on a CUDA device, "
                         f"got {dev}")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"the beam_step kernel is built for sm_90a "
                           f"(Hopper); {torch.cuda.get_device_name(dev)} is "
                           f"sm_{cap[0]}{cap[1]}")


def _need(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def beam_step_cuda(state, ctxs, adj, table, budgets, hop_limits, *, kind,
                   active_count: torch.Tensor | None = None):
    """Advance every lane of ``state`` by one hop on the card, in place.

    Shapes and dtypes as :func:`repro_torch.kernels.ref.beam_step_ref`;
    ``budgets``/``hop_limits`` are (Q,) int32 (or broadcastable scalars).
    ``active_count`` (one int32 on the card, optional) gains one for every
    lane that can still move after this hop.  Returns ``state``.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown beam_step kind {kind!r}")
    beam_ids, beam_d, beam_exp, visited, hops, evals = state
    dev = beam_ids.device
    _check_card(dev)
    q, width = beam_ids.shape
    r = adj.shape[1]
    if width + r > _MAX_CANDIDATES:
        raise ValueError(f"beam width + degree = {width + r} exceeds "
                         f"{_MAX_CANDIDATES}")
    n = table.shape[0]
    nw = (n + 31) // 32
    _need(beam_ids, "beam_ids", torch.int32, (q, width), dev)
    _need(beam_d, "beam_d", torch.float32, (q, width), dev)
    _need(beam_exp, "beam_exp", torch.bool, (q, width), dev)
    _need(visited, "visited", torch.int32, (q, nw), dev)
    _need(hops, "hops", torch.int32, (q,), dev)
    _need(evals, "evals", torch.int32, (q,), dev)
    _need(adj, "adj", torch.int32, (adj.shape[0], r), dev)
    budgets = torch.as_tensor(budgets, dtype=torch.int32, device=dev)
    budgets = budgets.expand(q).contiguous()
    hop_limits = torch.as_tensor(hop_limits, dtype=torch.int32, device=dev)
    hop_limits = hop_limits.expand(q).contiguous()
    if kind == "exact":
        dim, k = table.shape[1], 0
        _need(table, "table", torch.float32, (n, dim), dev)
        _need(ctxs, "ctxs", torch.float32, (q, dim), dev)
    else:
        dim, k = table.shape[1], ctxs.shape[-1]
        _need(table, "table", torch.uint8, (n, dim), dev)
        _need(ctxs, "ctxs", torch.float32, (q, dim, k), dev)
    vec4 = int(dim % 4 == 0 and table.data_ptr() % 16 == 0
               and ctxs.data_ptr() % 16 == 0)
    if active_count is not None:
        _need(active_count, "active_count", torch.int32, (1,), dev)
    fn = _library()
    rc = fn(_KINDS[kind], q, width, r, nw, dim, k, vec4,
            beam_ids.data_ptr(), beam_d.data_ptr(), beam_exp.data_ptr(),
            visited.data_ptr(), hops.data_ptr(), evals.data_ptr(),
            ctxs.data_ptr(), adj.data_ptr(), table.data_ptr(),
            budgets.data_ptr(), hop_limits.data_ptr(),
            active_count.data_ptr() if active_count is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beam_step kernel launch failed: CUDA error {rc}")
    launches[kind] += 1
    return state
