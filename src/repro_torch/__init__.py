"""MCGI in PyTorch for NVIDIA Hopper.

The port of :mod:`repro` (JAX) to PyTorch + hand-written CUDA.  It mirrors
``repro``'s layout module for module and never imports ``jax`` or ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
CUDA device is present unless the caller asks for ``device="cpu"``.  On the
CPU every kernel wrapper runs its plain PyTorch version; on a CUDA tensor it
launches the kernel or raises.

Float32 matrix products and convolutions run in full float32: TF32 keeps
about three decimal digits, which would break the 1e-4 L2 tolerances the port
is held to.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The torch device an entry point runs on; raises for a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
