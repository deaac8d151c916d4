"""Decoder-only transformer covering the LM zoo's five architectures (port
of :mod:`repro.models.transformer`, its serving path).

One config dataclass expresses dense (qwen2-7b, deepseek-coder-33b,
minicpm-2b) and MoE (qwen3-moe-30b-a3b, deepseek-v2-lite-16b) variants
with GQA or MLA attention.  Parameters are a dict: ``embed`` (V, D),
``layers`` (a list with one dict per layer: ``ln_attn``, ``ln_ffn``,
``attn``, and ``ffn`` or ``moe``), ``ln_final`` and ``lm_head`` (absent
when embeddings are tied).  An MoE net's first ``first_k_dense`` layers
carry ``ffn``, the rest ``moe``.  The reference stacks the layers on a
leading axis (a dense prefix in its own ``dense_layers`` stack) and scans
over them; here a Python loop walks the list.  The reference stores
float32 and casts every layer, the embedding rows and the head to
``cfg.dtype`` before any use, so the port may store its parameters in
``cfg.dtype`` directly (bfloat16 at full width) with the same results.

Entry points: :func:`lm_loss` (causal LM training loss), :func:`forward`,
:func:`prefill` (last-position logits) and :func:`decode_step` (one token
against the cache of :func:`init_cache`).  The first three take an
optional ``mesh`` (a ("data", "model") ``ShardMesh``, where the reference
takes a ``ShardCtx``): its MoE layers then run the expert-parallel
schedule of :mod:`repro_torch.models.moe`.  Whenever autograd records
(grad enabled and any parameter or the input requiring grad), each layer
of :func:`forward` runs under ``torch.utils.checkpoint``, as the
reference's ``remat`` (on in every config) rematerialises it: backward
recomputes the layer from its input, so one layer's activations are
alive at a time, not every layer's (at minicpm-2b's width and a
4,096-token sequence that decides whether training fits on one card).
Serving, whose parameters need no gradient, runs the layers plainly.
The reference's ``remat`` field, like its XLA-only knobs
``unroll_layers``, ``attn_unroll`` and ``skip_masked_blocks``, is left
out: they choose how XLA schedules, unrolls or rematerialises the same
computation and change nothing the model computes.  A trainer keeps
float32 master weights (``init_lm(..., dtype=torch.float32)``), as the
reference does; each layer is cast to ``cfg.dtype`` where it is used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod

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
    attention: str = "gqa"              # "gqa" | "mla"
    qkv_bias: bool = False
    qk_norm: bool = False
    moe: moe_mod.MoeConfig | None = None
    first_k_dense: int = 0              # deepseek: leading dense layers in MoE nets
    mla: attn_mod.MlaConfig | None = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MiniCPM (mup-style) scaling knobs [arXiv:2404.06395].
    scale_emb: float = 1.0
    scale_depth: float = 0.0            # 0 => residual scale 1
    dim_model_base: int = 0             # 0 => logit scale 1
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    attn_chunk_q: int = 256
    attn_chunk_k: int = 1024
    aux_loss_weight: float = 0.01

    @property
    def gqa(self) -> attn_mod.GqaConfig:
        return attn_mod.GqaConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, attn_chunk_q=self.attn_chunk_q,
            attn_chunk_k=self.attn_chunk_k)

    @property
    def residual_scale(self) -> float:
        if self.scale_depth:
            return self.scale_depth / (self.n_layers ** 0.5)
        return 1.0

    @property
    def logit_scale(self) -> float:
        if self.dim_model_base:
            return self.dim_model_base / self.d_model
        return 1.0

    @property
    def dense_prefix(self) -> int:
        """Leading layers that carry a dense FFN in an MoE net."""
        return self.first_k_dense if self.moe is not None else 0

    def n_params(self) -> int:
        """Total parameter count (shapes only, on the meta device)."""
        p = init_lm(self, None, device="meta")
        return sum(math.prod(t.shape) for t in leaves(p))

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        p = init_lm(self, None, device="meta")
        total = sum(math.prod(t.shape) for t in leaves(p))
        for layer in p["layers"]:
            if "moe" in layer:
                routed = sum(math.prod(layer["moe"][w].shape)
                             for w in ("w_gate", "w_up", "w_down"))
                total -= routed - routed * self.moe.top_k // self.moe.n_experts
        return total


def _check_attention(cfg: TransformerConfig) -> None:
    if cfg.attention not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: unknown attention {cfg.attention!r} "
                         f"(known: 'gqa', 'mla')")


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
    1/sqrt(d_in), embedding, head and router by 0.02, unit norms, zero
    biases), not its random bits."""
    _check_attention(cfg)
    dev = layers.init_device(device)
    kw = dict(dtype=cfg.dtype if dtype is None else dtype, device=dev)
    p: Params = {"embed": layers.embed_init(generator, cfg.vocab,
                                            cfg.d_model, **kw)}
    kd = cfg.dense_prefix

    def layer(i: int) -> Params:
        lp = {"ln_attn": torch.ones((cfg.d_model,), **kw),
              "ln_ffn": torch.ones((cfg.d_model,), **kw)}
        if cfg.attention == "mla":
            lp["attn"] = attn_mod.mla_init(generator, cfg.mla, **kw)
        else:
            lp["attn"] = attn_mod.gqa_init(generator, cfg.gqa, **kw)
        if cfg.moe is not None and i >= kd:
            lp["moe"] = moe_mod.moe_init(generator, cfg.moe, **kw)
        else:
            lp["ffn"] = layers.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                           **kw)
        return lp

    p["layers"] = [layer(i) for i in range(cfg.n_layers)]
    p["ln_final"] = torch.ones((cfg.d_model,), **kw)
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(generator, cfg.d_model, cfg.vocab,
                                         scale=0.02, **kw)
    return p


def _embed(cfg: TransformerConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(cfg.dtype)
    return x * cfg.scale_emb if cfg.scale_emb != 1.0 else x


def _residual(cfg: TransformerConfig, x: torch.Tensor,
              branch: torch.Tensor) -> torch.Tensor:
    rs = cfg.residual_scale
    return x + (branch * rs if rs != 1.0 else branch)


def _ffn(cfg: TransformerConfig, p: Params, h: torch.Tensor, no_drop: bool,
         mesh=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], cfg.moe, h, no_drop=no_drop,
                                 mesh=mesh)
    return layers.swiglu(p["ffn"], h), None


def _train_layer(cfg: TransformerConfig, p_layer: Params, x: torch.Tensor,
                 aux: torch.Tensor, mesh=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of the train path: (x, aux) -> (x, aux plus the layer's
    load-balance loss).  The cast to ``cfg.dtype`` happens here, so under
    the checkpoint the cast weights are recomputed, not kept for backward.
    An MoE layer on ``mesh`` runs as :func:`moe_mod.moe_apply` decides."""
    p = _cast(p_layer, cfg.dtype)
    h = layers.rms_norm(x, p["ln_attn"])
    if cfg.attention == "mla":
        a = attn_mod.mla_train(p["attn"], cfg.mla, h)
    else:
        a = attn_mod.gqa_train(p["attn"], cfg.gqa, h)
    x = _residual(cfg, x, a)
    h = layers.rms_norm(x, p["ln_ffn"])
    out, a_loss = _ffn(cfg, p, h, no_drop=False, mesh=mesh)
    if a_loss is not None:
        aux = aux + a_loss
    return _residual(cfg, x, out), aux


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, D), aux_loss): the sum of the MoE
    layers' load-balance losses (0 for a dense model).  MoE layers drop
    assignments past capacity_factor; on a ("data", "model") ``mesh``
    (a :class:`~repro_torch.distributed.mesh.ShardMesh`, the reference's
    ``ShardCtx``) they run the expert-parallel schedule where its shapes
    allow, else one group per data shard.  When autograd records, each
    layer runs under ``torch.utils.checkpoint`` (the same values; backward
    runs each layer's forward again, its exchanges included)."""
    _check_attention(cfg)
    x = _embed(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    records = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad
                               for t in leaves(params["layers"])))
    for p_layer in params["layers"]:
        if records:
            x, aux = torch.utils.checkpoint.checkpoint(
                _train_layer, cfg, p_layer, x, aux, mesh,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _train_layer(cfg, p_layer, x, aux, mesh)
    x = layers.rms_norm(x, params["ln_final"].to(x.dtype))
    return x, aux


def logits_from_hidden(cfg: TransformerConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    """x @ head in x's dtype (the head is ``embed.T`` when tied), times
    ``logit_scale``."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    ls = cfg.logit_scale
    return logits * ls if ls != 1.0 else logits


def lm_loss(cfg: TransformerConfig, params: Params,
            batch: dict[str, torch.Tensor], mesh=None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Causal LM loss.  batch: tokens (B, S), labels (B, S) (negative =
    ignore, the reference's -100).  Returns (ce + aux_loss_weight * aux,
    {"ce", "aux"}), the cross entropy in float32 over the kept labels.
    ``mesh``: as :func:`forward`."""
    x, aux = forward(cfg, params, batch["tokens"], mesh)
    logits = logits_from_hidden(cfg, params, x)
    labels = batch["labels"]
    mask = labels >= 0
    loss = layers.cross_entropy(logits, labels.clamp_min(0), mask)
    return loss + cfg.aux_loss_weight * aux, {"ce": loss, "aux": aux}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Per-layer cache stacked on a leading layer axis, zeros: GQA
    {"k", "v"} of (n_layers, B, max_len, Hkv, d_head); MLA's latent cache
    {"c_kv": (n_layers, B, max_len, r), "k_rope": (n_layers, B, max_len,
    dr)}.  (The reference splits an MoE net's stack into "dense" and
    "scanned"; here one stack holds every layer in order.)"""
    _check_attention(cfg)
    dev = layers.init_device(device)
    kw = dict(dtype=dtype, device=dev)
    if cfg.attention == "mla":
        m = cfg.mla
        return {"c_kv": torch.zeros((cfg.n_layers, batch, max_len,
                                     m.kv_lora_rank), **kw),
                "k_rope": torch.zeros((cfg.n_layers, batch, max_len,
                                       m.qk_rope_dim), **kw)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def decode_step(cfg: TransformerConfig, params: Params, cache: Params,
                tokens: torch.Tensor, kv_len: torch.Tensor,
                mla_absorbed: bool = True) -> tuple[torch.Tensor, Params]:
    """One decode step. tokens (B, 1); kv_len (B,) -> (logits (B, V),
    cache).  The cache is updated in place (layer i's entry written at
    kv_len[b]) and returned.  GQA attention is one
    ``ops.decode_attention`` launch a layer on the card; MLA runs the
    absorbed form unless ``mla_absorbed=False``.  MoE layers run with
    ``no_drop`` (every assignment kept)."""
    _check_attention(cfg)
    x = _embed(cfg, params, tokens)
    for i, p_layer in enumerate(params["layers"]):
        p = _cast(p_layer, cfg.dtype)
        hn = layers.rms_norm(x, p["ln_attn"])
        layer_cache = {name: c[i] for name, c in cache.items()}
        if cfg.attention == "mla":
            a, _ = attn_mod.mla_decode(p["attn"], cfg.mla, hn, layer_cache,
                                       kv_len, absorbed=mla_absorbed)
        else:
            a, _ = attn_mod.gqa_decode(p["attn"], cfg.gqa, hn, layer_cache,
                                       kv_len)
        x = _residual(cfg, x, a)
        hn = layers.rms_norm(x, p["ln_ffn"])
        out, _ = _ffn(cfg, p, hn, no_drop=True)
        x = _residual(cfg, x, out)
    x = layers.rms_norm(x, params["ln_final"].to(x.dtype))
    return logits_from_hidden(cfg, params, x)[:, 0], cache


def prefill(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Full forward over the prompt; last-position logits (B, V).
    ``mesh``: as :func:`forward`."""
    x, _ = forward(cfg, params, tokens, mesh)
    return logits_from_hidden(cfg, params, x[:, -1:, :])[:, 0]
