"""Decoder-only dense transformer (port of :mod:`repro.models.transformer`
for dense GQA configs such as qwen2-7b).

Parameters are a dict: ``embed`` (V, D), ``layers`` (a list with one dict
per layer: ``ln_attn``, ``ln_ffn``, ``attn``, ``ffn``), ``ln_final`` and
``lm_head``.  The reference stacks the
layers on a leading axis and scans over them; here a Python loop walks the
list.  The reference stores float32 and casts every layer, the embedding
rows and the head to ``cfg.dtype`` before any use, so the port may store
its parameters in ``cfg.dtype`` directly (bfloat16 at full width: about
15.2 GB for qwen2-7b) with the same results.

Entry points: :func:`forward`, :func:`prefill` (last-position logits) and
:func:`decode_step` (one token against the KV cache of
:func:`init_cache`).  MoE and MLA configs raise ``NotImplementedError``
(ROADMAP Queue 1 item 14); they never run a partial model.  The
reference's qwen3-style q/k norm, tied embeddings and MiniCPM scaling
knobs (scale_emb, scale_depth, dim_model_base) come with the first config
that sets them; at their defaults they are off or multiply by 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attention: str = "gqa"              # "gqa" | "mla" (mla not ported)
    qkv_bias: bool = False
    moe: Any = None                     # MoE not ported
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    attn_chunk_q: int = 256
    attn_chunk_k: int = 1024

    @property
    def gqa(self) -> attn_mod.GqaConfig:
        return attn_mod.GqaConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta, attn_chunk_q=self.attn_chunk_q,
            attn_chunk_k=self.attn_chunk_k)

    def n_params(self) -> int:
        """Total parameter count (shapes only, on the meta device)."""
        p = init_lm(self, None, device="meta")
        return sum(math.prod(t.shape) for t in leaves(p))


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.moe is not None or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA decode are not ported yet (ROADMAP "
            f"Queue 1 item 14); the port runs dense GQA configs only")


def leaves(tree):
    """The tensors of a parameter tree (dicts and lists), in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def init_lm(cfg: TransformerConfig, generator: torch.Generator | None,
            device="cuda", dtype: torch.dtype | None = None) -> Params:
    """Draw the model's parameters from ``generator`` in ``dtype``
    (default ``cfg.dtype``) on ``device`` (``"meta"``: shapes only): the
    reference's initialisation laws (normal weights scaled by
    1/sqrt(d_in), embedding and head by 0.02, unit norms, zero biases),
    not its random bits."""
    _check_dense(cfg)
    dev = layers.init_device(device)
    kw = dict(dtype=cfg.dtype if dtype is None else dtype, device=dev)
    p: Params = {"embed": layers.embed_init(generator, cfg.vocab,
                                            cfg.d_model, **kw)}
    p["layers"] = [{
        "ln_attn": torch.ones((cfg.d_model,), **kw),
        "ln_ffn": torch.ones((cfg.d_model,), **kw),
        "attn": attn_mod.gqa_init(generator, cfg.gqa, **kw),
        "ffn": layers.swiglu_init(generator, cfg.d_model, cfg.d_ff, **kw),
    } for _ in range(cfg.n_layers)]
    p["ln_final"] = torch.ones((cfg.d_model,), **kw)
    p["lm_head"] = layers.dense_init(generator, cfg.d_model, cfg.vocab,
                                     scale=0.02, **kw)
    return p


def _embed(cfg: TransformerConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.dtype)


def forward(cfg: TransformerConfig, params: Params,
            tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, D), aux_loss); the aux loss of a
    dense model is 0."""
    _check_dense(cfg)
    x = _embed(cfg, params, tokens)
    for p_layer in params["layers"]:
        p = _cast(p_layer, cfg.dtype)
        h = layers.rms_norm(x, p["ln_attn"])
        x = x + attn_mod.gqa_train(p["attn"], cfg.gqa, h)
        h = layers.rms_norm(x, p["ln_ffn"])
        x = x + layers.swiglu(p["ffn"], h)
    x = layers.rms_norm(x, params["ln_final"].to(x.dtype))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_from_hidden(cfg: TransformerConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    return x @ params["lm_head"].to(x.dtype)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Per-layer KV cache stacked on a leading layer axis:
    {"k", "v"} of (n_layers, B, max_len, Hkv, d_head), zeros."""
    _check_dense(cfg)
    dev = layers.init_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(cfg: TransformerConfig, params: Params, cache: Params,
                tokens: torch.Tensor,
                kv_len: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """One decode step. tokens (B, 1); kv_len (B,) -> (logits (B, V),
    cache).  The cache is updated in place (layer i's K/V written at
    kv_len[b]) and returned; each layer's attention is one
    ``ops.decode_attention`` launch on the card."""
    _check_dense(cfg)
    x = _embed(cfg, params, tokens)
    for i, p_layer in enumerate(params["layers"]):
        p = _cast(p_layer, cfg.dtype)
        hn = layers.rms_norm(x, p["ln_attn"])
        a, _ = attn_mod.gqa_decode(p["attn"], cfg.gqa, hn,
                                   {"k": cache["k"][i], "v": cache["v"][i]},
                                   kv_len)
        x = x + a
        hn = layers.rms_norm(x, p["ln_ffn"])
        x = x + layers.swiglu(p["ffn"], hn)
    x = layers.rms_norm(x, params["ln_final"].to(x.dtype))
    return logits_from_hidden(cfg, params, x)[:, 0], cache


def prefill(cfg: TransformerConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full forward over the prompt; last-position logits (B, V)."""
    x, _ = forward(cfg, params, tokens)
    return logits_from_hidden(cfg, params, x[:, -1:, :])[:, 0]
