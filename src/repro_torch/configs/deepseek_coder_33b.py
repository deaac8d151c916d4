"""deepseek-coder-33b [arXiv:2401.14196]: dense llama-arch, 62L d_model=7168
56H (GQA kv=8) d_ff=19200 vocab=32256 (the port's copy of
``repro/configs/deepseek_coder_33b.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=19200,
    vocab=32256,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = TransformerConfig(
    name="deepseek-coder-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=160,
    vocab=512,
    dtype=torch.float32,
    attn_chunk_q=16,
    attn_chunk_k=16,
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="deepseek-coder-33b",
        family="lm",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.lm_shapes(),
        source="arXiv:2401.14196",
    )
)
