"""A step's cost, counted op by op, and its roofline on one H100 (the
counterpart of :mod:`repro.launch.hlo_analysis`; the name is kept so a
reader finds it, but the port has no HLO).

The reference reads XLA's ``cost_analysis`` and parses collectives out of
the compiled HLO.  The port runs eager PyTorch, so :class:`CostMode` (a
``TorchDispatchMode``) watches every aten op a step dispatches, on meta
tensors, and counts

* FLOPs, from ``torch.utils.flop_counter``'s formula registry, tallied by
  the dtype of the op's first tensor input (the product's operands);
* bytes accessed: each op's tensor inputs read once and its outputs
  written once.  Views count nothing, nor does an allocation (``empty``).
  This is eager and unfused, so it is an upper bound on what a fused
  program moves;
* peak live bytes: every storage on the counted device from its creation
  until it is freed, on top of the storages alive when counting began.

A kernel's meta branch (``kernels.ops.shapes_only``) adds no FLOPs and no
bytes, as XLA gives a Pallas custom call none; ``ops.shape_calls`` names
the kernels a step reached, so a reader sees what was not priced.

There is no collective term: one card has no interconnect to price, and
the reference's ``collective_bytes`` has no counterpart.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 (700 W) data sheet, dense: bf16 / fp16 on the tensor
# cores, float32 on the SIMT units (TF32 is off in the port), FP64 SIMT,
# int8 tensor cores; HBM3 bandwidth.
PEAK_FLOPS = {
    torch.bfloat16: 989e12,
    torch.float16: 989e12,
    torch.float32: 67e12,
    torch.float64: 34e12,
    torch.int8: 1979e12,
}
DEFAULT_PEAK = PEAK_FLOPS[torch.float32]   # any other dtype: SIMT rate
HBM_BW = 3.35e12                           # bytes/s
HBM_BYTES = 80e9                           # device memory
META = torch.device("meta")

_ALLOC_ONLY = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> list[torch.Tensor]:
    """The tensors among ``xs`` and in its lists and tuples (an aten op's
    arguments and results nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


class CostMode(TorchDispatchMode):
    """Count FLOPs (by dtype), bytes accessed and peak live bytes of the
    ops dispatched inside the mode, for storages on the meta device (a
    host tensor, such as the optimizer's step counter, counts nothing).

    ``live`` are tensors alive when counting begins (the step's
    arguments); their storages count toward the peak until freed.
    """

    def __init__(self, live=()):
        super().__init__()
        self.flops_by_dtype: dict[str, int] = {}
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: set[int] = set()
        for t in live:
            self._track(t)
        self.start_bytes = self.live_bytes

    def _track(self, t: torch.Tensor) -> None:
        if t.device != META:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live_bytes -= n

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            if n:
                key = str(ins[0].dtype).replace("torch.", "")
                self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0) + n
        if not func.is_view and func not in _ALLOC_ONLY:
            self.bytes_accessed += sum(
                tensor_bytes(t) for t in ins + outs if t.device == META)
        for t in outs:
            self._track(t)
        return out


def roofline_terms(*, flops_by_dtype: dict[str, float],
                   bytes_accessed: float) -> dict:
    """The roofline terms of one H100, in seconds: each dtype's FLOPs over
    its peak (summed), and the bytes over HBM bandwidth."""
    compute_s = 0.0
    for name, n in flops_by_dtype.items():
        dtype = getattr(torch, name, None)
        compute_s += n / PEAK_FLOPS.get(dtype, DEFAULT_PEAK)
    terms = {"compute_s": compute_s, "memory_s": bytes_accessed / HBM_BW}
    dominant = max(("compute_s", "memory_s"), key=lambda k: terms[k])
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    terms["peaks"] = {"flops_per_s": {str(k).replace("torch.", ""): v
                                      for k, v in PEAK_FLOPS.items()},
                      "other_flops_per_s": DEFAULT_PEAK,
                      "hbm_bytes_per_s": HBM_BW,
                      "source": "NVIDIA H100 SXM5 data sheet, 700 W, dense"}
    return terms
