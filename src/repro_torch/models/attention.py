"""Grouped-query attention for the dense LMs (port of the GQA half of
:mod:`repro.models.attention`): a train path (full causal self-attention
through :func:`blockwise_attention`) and a decode path (one token against a
KV cache through :func:`repro_torch.kernels.ops.decode_attention`, the CUDA
kernel on the card).  MLA waits (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.blockwise import blockwise_attention
from repro_torch.models.layers import dense_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GqaConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_chunk_q: int = 256
    attn_chunk_k: int = 1024


def gqa_init(generator: torch.Generator | None, cfg: GqaConfig, *,
             dtype=torch.float32, device="cuda") -> Params:
    kw = dict(dtype=dtype, device=layers.init_device(device))
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    p = {"wq": dense_init(generator, cfg.d_model, hq, **kw),
         "wk": dense_init(generator, cfg.d_model, hkv, **kw),
         "wv": dense_init(generator, cfg.d_model, hkv, **kw),
         "wo": dense_init(generator, hq, cfg.d_model, **kw)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq,), **kw)
        p["bk"] = torch.zeros((hkv,), **kw)
        p["bv"] = torch.zeros((hkv,), **kw)
    return p


def _project_qkv(p: Params, cfg: GqaConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_train(p: Params, cfg: GqaConfig, x: torch.Tensor) -> torch.Tensor:
    """Blockwise causal self-attention. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    g = cfg.n_heads // cfg.n_kv_heads
    q = q.reshape(b, s, cfg.n_kv_heads, g, cfg.d_head)
    o = blockwise_attention(q, k, v, chunk_q=min(cfg.attn_chunk_q, s),
                            chunk_k=min(cfg.attn_chunk_k, s), causal=True)
    return o.reshape(b, s, -1) @ p["wo"]


def gqa_init_cache(cfg: GqaConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda") -> Params:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dev = layers.init_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def write_at(buf: torch.Tensor, new: torch.Tensor,
             pos: torch.Tensor) -> None:
    """buf[b, pos[b]] = new[b] in place, for every row whose pos lies in
    [0, S); other rows keep their value (the reference's masked select
    writes nothing there).  No host synchronisation."""
    b, s = buf.shape[:2]
    rows = torch.arange(b, device=buf.device)
    idx = pos.clamp(0, s - 1).long()
    ok = ((pos >= 0) & (pos < s)).reshape((b,) + (1,) * (new.dim() - 1))
    buf[rows, idx] = torch.where(ok, new.to(buf.dtype), buf[rows, idx])


def gqa_decode(p: Params, cfg: GqaConfig, x: torch.Tensor, cache: Params,
               kv_len: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """One decode step. x: (B, 1, D); kv_len: (B,) current lengths.

    Returns (out (B, 1, D), cache).  The new token's K/V is written into
    ``cache`` in place at position kv_len[b] (skipped where kv_len[b] >= S),
    where the reference rewrites the whole cache with a masked select; the
    token then attends to kv_len[b] + 1 entries.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, kv_len[:, None])
    write_at(cache["k"], k[:, 0], kv_len)
    write_at(cache["v"], v[:, 0], kv_len)
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], kv_len + 1)
    o = o.to(x.dtype).reshape(b, 1, -1)
    return o @ p["wo"], cache
