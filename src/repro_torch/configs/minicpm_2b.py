"""minicpm-2b [arXiv:2404.06395]: dense llama-like, 40L d_model=2304 36H (MHA,
kv=36, d_head=64) d_ff=5760 vocab=122753; tied embeddings; mup-style scaling
(scale_emb=12, scale_depth=1.4, dim_model_base=256) (the port's copy of
``repro/configs/minicpm_2b.py``).

vocab is padded 122753 -> 122880 (a multiple of 256), as the reference pads
it; the extra logits are never labelled."""
import torch

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerConfig

VOCAB_RAW = 122753
VOCAB_PADDED = base.pad_to(VOCAB_RAW, 256)  # 122880

CONFIG = TransformerConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab=VOCAB_PADDED,
    tie_embeddings=True,
    scale_emb=12.0,
    scale_depth=1.4,
    dim_model_base=256,
    dtype=torch.bfloat16,
)

SMOKE_CONFIG = TransformerConfig(
    name="minicpm-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=160,
    vocab=512,
    tie_embeddings=True,
    scale_emb=12.0,
    scale_depth=1.4,
    dim_model_base=32,
    dtype=torch.float32,
    attn_chunk_q=16,
    attn_chunk_k=16,
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="minicpm-2b",
        family="lm",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.lm_shapes(),
        source="arXiv:2404.06395",
    )
)
