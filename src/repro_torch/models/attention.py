"""Attention variants of the LM zoo (port of :mod:`repro.models.attention`):
GQA (qwen2, qwen3, deepseek-coder, minicpm) and MLA (deepseek-v2-lite),
each with a train path (full causal self-attention through
:func:`blockwise_attention`) and a decode path (one token against a cache).

GQA decode runs :func:`repro_torch.kernels.ops.decode_attention`, the CUDA
kernel on the card.  MLA decode is torch matmuls, as the reference's is
plain ``jnp`` outside any Pallas kernel: its latent key is r + dr = 576
wide and its key and value widths differ, which the kernel does not take.
It comes in the reference's two forms: ``absorbed=True`` attends in the
r-dim latent space (W_uk folded into the query, W_uv applied after the
weighted latent sum) and never materialises (S, H, d) keys or values;
``absorbed=False`` expands the latent to full K/V.
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
    qk_norm: bool = False       # qwen3-style per-head RMS on q/k
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
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.d_head,), **kw)
        p["k_norm"] = torch.ones((cfg.d_head,), **kw)
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
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"])
        k = layers.rms_norm(k, p["k_norm"])
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


# ----------------------------------------------------------------------- MLA

@dataclasses.dataclass(frozen=True)
class MlaConfig:
    """DeepSeek-V2 Multi-head Latent Attention (arXiv:2405.04434).

    V2-Lite: kv_lora_rank=512, no q compression, 16 heads,
    qk_nope=128, qk_rope=64, v_head=128.
    """

    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    attn_chunk_q: int = 256
    attn_chunk_k: int = 1024


def mla_init(generator: torch.Generator | None, cfg: MlaConfig, *,
             dtype=torch.float32, device="cuda") -> Params:
    kw = dict(dtype=dtype, device=layers.init_device(device))
    h, r = cfg.n_heads, cfg.kv_lora_rank
    return {
        # Queries (uncompressed in V2-Lite).
        "wq": dense_init(generator, cfg.d_model,
                         h * (cfg.qk_nope_dim + cfg.qk_rope_dim), **kw),
        # Joint KV down-projection + decoupled rope key.
        "w_dkv": dense_init(generator, cfg.d_model, r + cfg.qk_rope_dim,
                            **kw),
        "kv_norm": torch.ones((r,), **kw),
        # Up-projections from the latent.
        "w_uk": dense_init(generator, r, h * cfg.qk_nope_dim, **kw),
        "w_uv": dense_init(generator, r, h * cfg.v_head_dim, **kw),
        "wo": dense_init(generator, h * cfg.v_head_dim, cfg.d_model, **kw),
    }


def _mla_latent(p: Params, cfg: MlaConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """Compressed KV path: returns (c_kv (B, S, r), k_rope (B, S, 1, dr))."""
    c_kv, k_rope = (x @ p["w_dkv"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = layers.rms_norm(c_kv, p["kv_norm"])
    k_rope = layers.apply_rope(k_rope[..., None, :], positions,
                               cfg.rope_theta)   # shared across heads
    return c_kv, k_rope


def _mla_query(p: Params, cfg: MlaConfig, x: torch.Tensor,
               positions: torch.Tensor):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, dr) roped)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads,
                              cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)


def mla_train(p: Params, cfg: MlaConfig, x: torch.Tensor) -> torch.Tensor:
    """Blockwise causal MLA self-attention. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, cfg.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, cfg.v_head_dim)
    # (nope | rope) folded into one key dim: blockwise attention's d^-0.5
    # over d = nope + rope is MLA's scale; each head is its own KV head
    # with a group of 1, and the shared rope key broadcasts across heads.
    q_full = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, cfg.qk_rope_dim)],
                       dim=-1)
    o = blockwise_attention(q_full, k_full, v,
                            chunk_q=min(cfg.attn_chunk_q, s),
                            chunk_k=min(cfg.attn_chunk_k, s), causal=True)
    return o.reshape(b, s, -1) @ p["wo"]


def mla_init_cache(cfg: MlaConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda") -> Params:
    """The latent cache: r + dr values a token, MLA's memory win."""
    dev = layers.init_device(device)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=dev),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=dev)}


def mla_decode(p: Params, cfg: MlaConfig, x: torch.Tensor, cache: Params,
               kv_len: torch.Tensor,
               absorbed: bool = True) -> tuple[torch.Tensor, Params]:
    """One MLA decode step against the latent cache. x: (B, 1, D); kv_len:
    (B,) current lengths.  The new token's latent and rope key are written
    into ``cache`` in place at kv_len[b] (skipped where kv_len[b] >= S);
    it then attends to kv_len[b] + 1 entries.  Returns (out (B, 1, D),
    cache).

    The reference's rounding points: the query and ``q_lat`` in x's
    dtype; in the absorbed form the logits, the softmax, the latent sum and
    ``w_uv`` in float32; in the naive form K/V in x's dtype, the logits and
    softmax in float32, the weights cast back.  The output is cast to x's
    dtype once, before ``wo``.
    """
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    positions = kv_len[:, None]
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    c_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    write_at(cache["c_kv"], c_new[:, 0], kv_len)
    write_at(cache["k_rope"], k_rope_new[:, 0, 0], kv_len)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s_max = c_kv.shape[1]
    mask = (torch.arange(s_max, device=x.device)[None, :]
            < (kv_len + 1)[:, None])                          # (B, S)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]               # (B, H, d)

    if absorbed:
        # q~ = W_uk^T q_nope: (B, H, r); scores in latent space.
        w_uk = p["w_uk"].reshape(r, h, cfg.qk_nope_dim)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope, w_uk)
        c32 = c_kv.float()
        logits = torch.einsum("bhr,bsr->bhs", q_lat.float(), c32)
        logits = logits + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                                       k_rope.float())
        logits = (logits * scale).masked_fill(~mask[:, None], -torch.inf)
        w = torch.softmax(logits, dim=-1)
        lat = torch.einsum("bhs,bsr->bhr", w, c32)
        w_uv = p["w_uv"].reshape(r, h, cfg.v_head_dim)
        o = torch.einsum("bhr,rhd->bhd", lat, w_uv.float())
    else:
        c_x = c_kv.to(x.dtype)
        k_nope = (c_x @ p["w_uk"]).reshape(b, s_max, h, cfg.qk_nope_dim)
        v = (c_x @ p["w_uv"]).reshape(b, s_max, h, cfg.v_head_dim)
        rope_t = torch.promote_types(q_rope.dtype, k_rope.dtype)
        logits = (torch.einsum("bhd,bshd->bhs", q_nope, k_nope).float()
                  + torch.einsum("bhd,bsd->bhs", q_rope.to(rope_t),
                                 k_rope.to(rope_t)).float())
        logits = (logits * scale).masked_fill(~mask[:, None], -torch.inf)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bhs,bshd->bhd", w, v)
    o = o.to(x.dtype).reshape(b, 1, -1)
    return o @ p["wo"], cache
