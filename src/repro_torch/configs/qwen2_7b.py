"""qwen2-7b [arXiv:2407.10671]: dense, 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064, QKV bias (the port's copy of
``repro/configs/qwen2_7b.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = TransformerConfig(
    name="qwen2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab=512,
    qkv_bias=True,
    dtype=torch.float32,
    attn_chunk_q=16,
    attn_chunk_k=16,
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="qwen2-7b",
        family="lm",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.lm_shapes(),
        source="arXiv:2407.10671",
    )
)
