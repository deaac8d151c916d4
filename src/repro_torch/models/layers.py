"""Shared neural-net building blocks (port of :mod:`repro.models.layers`).

Parameters are plain dicts of tensors.  Init functions draw from a
``torch.Generator`` straight into the requested dtype and device, so a
full-width model is drawn in bfloat16 on the card without a float32 copy.
Like every entry point of the port they default to the card and raise
without one unless the caller asks for ``device="cpu"``
(``device="meta"`` gives shapes only).  The reference's ``ShardCtx`` /
``constrain`` (TPU-mesh sharding) have no counterpart on one card.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

Params = dict[str, Any]


def init_device(device) -> torch.device:
    """The device parameters are drawn on: the card, the CPU when asked,
    or ``"meta"`` for shapes only; raises for a missing card."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def dense_init(generator: torch.Generator | None, d_in: int, d_out: int,
               scale: float | None = None, *, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                    device=init_device(device))
    return w.mul_(scale)


def embed_init(generator: torch.Generator | None, vocab: int, d: int, *,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, dtype=dtype,
                    device=init_device(device))
    return w.mul_(0.02)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32, cast back to x's dtype, then scaled by gamma
    in that dtype (the reference's rounding points)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32 with the reference's eps (1e-6, not torch's
    1e-5), cast back to x's dtype, then ``* gamma + beta`` in that
    dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, d_head); positions broadcastable to (..., S).  The
    rotation runs in float32 (a bfloat16 x promotes) and is cast back."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_init(generator: torch.Generator | None, d: int, f: int, *,
                dtype=torch.float32, device="cuda") -> Params:
    kw = dict(dtype=dtype, device=init_device(device))
    return {"w_gate": dense_init(generator, d, f, **kw),
            "w_up": dense_init(generator, d, f, **kw),
            "w_down": dense_init(generator, f, d, **kw)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


def mlp_init(generator: torch.Generator | None, sizes: tuple[int, ...], *,
             dtype=torch.float32, device="cuda") -> Params:
    """``w{i}`` (sizes[i], sizes[i+1]) at :func:`dense_init`'s 1/sqrt(d_in)
    scale and zero ``b{i}``, for each consecutive pair of ``sizes``."""
    kw = dict(dtype=dtype, device=init_device(device))
    n = len(sizes) - 1
    p = {f"w{i}": dense_init(generator, sizes[i], sizes[i + 1], **kw)
         for i in range(n)}
    p.update({f"b{i}": torch.zeros((sizes[i + 1],), **kw)
              for i in range(n)})
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: Callable = F.relu,
              final_act: bool = False) -> torch.Tensor:
    """``x @ w{i} + b{i}`` for each layer, ``act`` between layers (and
    after the last with ``final_act``)."""
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level cross entropy in float32: logsumexp minus the gold
    logit, averaged over the tokens ``mask`` keeps (its sum floored at 1).

    logits: (..., V); labels: (...); mask broadcastable to labels (1 =
    keep)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
