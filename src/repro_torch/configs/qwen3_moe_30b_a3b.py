"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d_model=2048 32H (GQA kv=4)
vocab=151936, MoE 128 experts top-8, expert d_ff=768, QK-norm, no shared
experts; ~30.5B total / ~3.3B active parameters (the port's copy of
``repro/configs/qwen3_moe_30b_a3b.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,  # unused (all layers MoE); kept for record
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoeConfig(d_model=2048, n_experts=128, top_k=8, d_expert=768),
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = TransformerConfig(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab=512,
    qk_norm=True,
    moe=MoeConfig(d_model=64, n_experts=8, top_k=2, d_expert=96),
    dtype=torch.float32,
    attn_chunk_q=16,
    attn_chunk_k=16,
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="qwen3-moe-30b-a3b",
        family="lm",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.lm_shapes(),
        source="hf:Qwen/Qwen3-30B-A3B",
    )
)
