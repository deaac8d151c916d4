"""mind [arXiv:1904.08030]: multi-interest retrieval — embed_dim=64,
n_interests=4, capsule routing iters=3, history length 50 (the port's copy
of ``repro/configs/mind.py``).  Item corpus sized to the retrieval_cand
cell (10^6 candidates)."""
from repro_torch.configs import base
from repro_torch.models.recsys import MindConfig

CONFIG = MindConfig(
    n_items=1_000_000,
    embed_dim=64,
    n_interests=4,
    capsule_iters=3,
    hist_len=50,
)

SMOKE_CONFIG = MindConfig(
    n_items=2000, embed_dim=16, n_interests=4, capsule_iters=3, hist_len=20
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="mind",
        family="recsys",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.RECSYS_SHAPES,
        source="arXiv:1904.08030",
    )
)
