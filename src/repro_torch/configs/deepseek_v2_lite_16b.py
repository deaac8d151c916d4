"""deepseek-v2-lite-16b [arXiv:2405.04434]: 27L d_model=2048 16H MLA
(kv_lora=512, nope=128, rope=64, v=128), vocab=102400, MoE 64 routed top-6 +
2 shared experts (d_expert=1408), first layer dense (d_ff=10944) (the port's
copy of ``repro/configs/deepseek_v2_lite_16b.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.models.attention import MlaConfig
from repro_torch.models.moe import MoeConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,  # the first_k_dense layer's FFN
    vocab=102400,
    attention="mla",
    mla=MlaConfig(
        d_model=2048, n_heads=16, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    ),
    moe=MoeConfig(
        d_model=2048, n_experts=64, top_k=6, d_expert=1408,
        n_shared=2, d_shared=1408,
    ),
    first_k_dense=1,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = TransformerConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=192,
    vocab=512,
    attention="mla",
    mla=MlaConfig(
        d_model=64, n_heads=4, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        attn_chunk_q=16, attn_chunk_k=16,
    ),
    moe=MoeConfig(d_model=64, n_experts=8, top_k=2, d_expert=48,
                  n_shared=2, d_shared=48),
    first_k_dense=1,
    dtype=torch.float32,
    attn_chunk_q=16,
    attn_chunk_k=16,
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="deepseek-v2-lite-16b",
        family="lm",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.lm_shapes(),
        source="arXiv:2405.04434",
    )
)
