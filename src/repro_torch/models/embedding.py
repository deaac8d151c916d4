"""EmbeddingBag and the fused multi-table embedding of the recsys archs
(port of :mod:`repro.models.embedding`).

``embedding_bag`` is a gather and a reduction over the bag axis, as the
reference builds it (it has no ``nn.EmbeddingBag`` either), so masked and
weighted bags round as the reference's do.  The multi-table layout fuses
every categorical table into one array with per-field row offsets (the
FBGEMM table-batched layout): one gather serves every field.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import init_device


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """Bagged lookup: table (V, D), indices (B, L) -> (B, D).

    ``mask`` (B, L) marks the valid entries of ragged bags padded to L.
    ``mean`` divides by max(valid entries, 1); ``max`` puts -inf on masked
    entries, so an all-masked bag gives -inf, as the reference's does."""
    vecs = table[indices.long()]                       # (B, L, D)
    if weights is not None:
        vecs = vecs * weights[..., None]
    if mask is not None:
        vecs = vecs * mask[..., None].to(vecs.dtype)
    if mode == "sum":
        return vecs.sum(1)
    if mode == "mean":
        if mask is not None:
            denom = mask.sum(1, keepdim=True).to(vecs.dtype)
        else:
            denom = torch.full((), float(indices.shape[1]),
                               dtype=torch.float32, device=vecs.device)
        return vecs.sum(1) / denom.clamp_min(1.0)
    if mode == "max":
        if mask is not None:
            vecs = vecs.masked_fill(~mask[..., None].bool(), float("-inf"))
        return vecs.amax(1)
    raise ValueError(mode)


# Tables are row-padded to this multiple (the reference tiles them over any
# production mesh with it); ghost rows are never indexed.
ROW_MULTIPLE = 512


def pad_rows(n: int, multiple: int = ROW_MULTIPLE) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class FusedTableSpec:
    """Static description of the fused categorical tables."""

    vocab_sizes: tuple[int, ...]
    dim: int

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return sum(self.vocab_sizes)

    @property
    def padded_rows(self) -> int:
        return pad_rows(self.total_rows)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, acc = [], 0
        for v in self.vocab_sizes:
            out.append(acc)
            acc += v
        return tuple(out)


def fused_table_init(generator: torch.Generator | None, spec: FusedTableSpec,
                     scale: float = 0.01, *, dtype=torch.float32,
                     device="cuda") -> torch.Tensor:
    """(padded_rows, dim) uniform in [-scale, scale): the reference's
    ``scale=0.01`` (its comment names 1/sqrt(dim); its code draws 0.01)."""
    t = torch.empty((spec.padded_rows, spec.dim), dtype=dtype,
                    device=init_device(device))
    if t.device.type == "meta":
        return t
    return t.uniform_(-scale, scale, generator=generator)


def fused_lookup(table: torch.Tensor, spec: FusedTableSpec,
                 sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids (B, n_fields) per-field local ids -> (B, n_fields, dim):
    the field offsets added, then one gather over the fused table."""
    offs = torch.tensor(spec.offsets, dtype=torch.int64,
                        device=sparse_ids.device)
    return table[sparse_ids.long() + offs]
