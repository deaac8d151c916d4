"""Int8 gradient compression with error feedback (port of
:mod:`repro.training.compression`).

Each gradient leaf is quantised to int8 with one symmetric scale before the
cross-replica reduction and dequantised after; the quantisation residual is
carried into the next step (error feedback, as in 1-bit SGD / EF-SGD), so
its bias does not accumulate.  On one card there is no reduction: the
transform is the quantise -> dequantise round trip around the optimizer
update, the order a hand-rolled ring all-reduce would use.

The scale and the payload follow the reference's leaves
(:func:`repro_torch.training.optimizer.reference_leaves`): in the
transformer, one ``amax`` over the same-named gradient of every layer of a
stack group, so one scale serves that tensor in every layer of the group,
as it does in the reference's stacked leaf; in any other model (the GAT's
layer list) one scale a tensor.  Rounding is half to even (``torch.round``, as
``jnp.round``).  Everything runs in place, one tensor at a time.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.training.optimizer import reference_leaves, tree_map

Params = Any


def leaf_scale(parts: list[torch.Tensor]) -> torch.Tensor:
    """max(amax / 127, 1e-12) over every part of one leaf (float32)."""
    amax = torch.stack([p.abs().max() for p in parts]).max()
    return torch.clamp(amax / 127.0, min=1e-12)


def quantize_with_scale(g: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``g`` at ``scale``: round half to even, clip to
    [-127, 127]."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (int8 codes, scale): symmetric per-leaf scaling."""
    scale = leaf_scale([g])
    return quantize_with_scale(g, scale), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads_with_feedback(grads: Params,
                                 error: Params) -> tuple[Params, Params]:
    """(grads, error) -> (compressed-then-decompressed grads, new error
    feedback), both written in place: g + e is quantised with its leaf's
    scale, g becomes the dequantised value and e the residual."""
    for (_, gs, _), (_, es, _) in zip(reference_leaves(grads),
                                      reference_leaves(error)):
        for g, e in zip(gs, es):
            if g.dtype != torch.float32:
                raise TypeError("compression takes float32 gradients")
            g.add_(e)
        scale = leaf_scale(gs)
        for g, e in zip(gs, es):
            deq = dequantize_leaf(quantize_with_scale(g, scale), scale)
            torch.sub(g, deq, out=e)
            g.copy_(deq)
    return grads, error


def init_error_feedback(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_allreduce_bytes(params: Params) -> tuple[int, int]:
    """(uncompressed float32 payload, int8 payload plus one float32 scale
    a reference leaf) of the gradient all-reduce."""
    leaves = reference_leaves(params)
    n = sum(t.numel() for _, ts, _ in leaves for t in ts)
    return 4 * n, n + 4 * len(leaves)
