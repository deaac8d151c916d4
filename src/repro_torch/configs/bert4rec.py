"""bert4rec [arXiv:1904.06690]: bidirectional sequential recommender —
embed_dim=64, 2 blocks, 2 heads, seq_len=200, cloze training (the port's
copy of ``repro/configs/bert4rec.py``).  Item corpus sized to the
retrieval_cand cell (10^6 candidates)."""
from repro_torch.configs import base
from repro_torch.models.recsys import Bert4RecConfig

CONFIG = Bert4RecConfig(
    n_items=1_000_000,
    embed_dim=64,
    n_blocks=2,
    n_heads=2,
    seq_len=200,
)

SMOKE_CONFIG = Bert4RecConfig(
    n_items=2000, embed_dim=32, n_blocks=2, n_heads=2, seq_len=24
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="bert4rec",
        family="recsys",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.RECSYS_SHAPES,
        source="arXiv:1904.06690",
    )
)
