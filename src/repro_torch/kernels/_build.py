"""Build and load the port's hand-written CUDA kernels.

Every kernel lives in ``repro_torch/csrc/<name>.cu`` behind a plain C entry
point.  At first use the source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library ``build/repro_torch/<name>-<sha1>.so`` at the repository
root (named by the source's hash, so an edited source builds anew) and
loaded with ``ctypes``.  No ``--use_fast_math``: ``logf``, ``sqrtf`` and the
divisions stay IEEE-accurate, which the LID kernel's 1e-4 tolerance needs.

:func:`build_all` starts one ``nvcc`` per library at once and waits for all,
so a caller that needs several kernels pays for the slowest build only.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's kernels are compiled "
                       "from source on the machine with the card")


class Library:
    """One ``csrc/<name>.cu`` source, its built library and its C entry
    point ``symbol`` with ctypes ``argtypes`` (returns a CUDA error code);
    ``extra`` maps further entry points of the library to their
    ``argtypes`` (each returns an int)."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 extra: dict | None = None):
        self.name = name
        self.src = _CSRC / f"{name}.cu"
        self.symbol = symbol
        self.symbols = {symbol: argtypes, **(extra or {})}
        # nvcc's report (registers, shared memory, spills) from a build here.
        self.build_log = ""
        self._fns: dict = {}
        self._lock = threading.Lock()

    def path(self) -> pathlib.Path:
        digest = hashlib.sha1(self.src.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def _start(self):
        """Start nvcc for this library (None when it is built already)."""
        out = self.path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(self.src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, out

    def _finish(self, started) -> None:
        if started is None:
            return
        proc, tmp, out = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src.name} "
                               f"({proc.returncode}):\n{err}")
        self.build_log = err
        os.replace(tmp, out)

    def build(self) -> pathlib.Path:
        """Build the library if it is not built yet; return its path."""
        self._finish(self._start())
        return self.path()

    def fn(self, symbol: str | None = None):
        """The loaded C entry point ``symbol`` (default: the main one;
        builds the library on first use)."""
        symbol = symbol or self.symbol
        with self._lock:
            if not self._fns:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.symbols.items():
                    f = getattr(lib, name)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                    self._fns[name] = f
        return self._fns[symbol]


def build_all(libs) -> None:
    """Compile every library of ``libs`` that is not built yet, one nvcc
    each, all started together; raises if any build fails."""
    started = [(lib, lib._start()) for lib in libs]
    errors = []
    for lib, s in started:
        try:
            lib._finish(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def check_card(dev: torch.device, kernel: str) -> None:
    """Raise unless ``dev`` is a CUDA device of compute capability 9.0."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel} needs tensors on a CUDA device, got {dev}")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"the {kernel} kernel is built for sm_90a "
                           f"(Hopper); {torch.cuda.get_device_name(dev)} is "
                           f"sm_{cap[0]}{cap[1]}")


def need(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def on_card(fn):
    """Run a ``*_cuda`` wrapper with its tensors' card current.  The
    libraries launch on the runtime's current device and read it for their
    caches (occupancy, shared-memory attributes), so a tensor on another
    card than the current one would pair its stream with the wrong device.
    The card is the first argument's (the first leaf of a state tuple); a
    tensor off the card passes through to the wrapper's own check."""

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        first = args[0]
        dev = (first[0] if isinstance(first, (tuple, list)) else first).device
        if dev.type != "cuda":
            return fn(*args, **kw)
        with torch.cuda.device(dev):
            return fn(*args, **kw)

    return wrapped


_COUNT_LOCK = threading.Lock()


def count(launches: dict, key: str) -> None:
    """Count one launch of ``key``: serving threads launch kernels at once,
    and ``+=`` on a dict entry is a read and a write the interpreter may
    switch threads between."""
    with _COUNT_LOCK:
        launches[key] += 1
