"""dlrm-mlperf [arXiv:1906.00091]: the MLPerf DLRM benchmark config on Criteo
1TB — 13 dense features, 26 categorical tables (published cardinalities,
~190M rows x 128 = ~97 GB fp32 fused table), bottom MLP 13-512-256-128, top
MLP 1024-1024-512-256-1, dot interaction (the port's copy of
``repro/configs/dlrm_mlperf.py``)."""
from repro_torch.configs import base
from repro_torch.models.recsys import CRITEO_1TB_VOCABS, DlrmConfig

CONFIG = DlrmConfig(
    n_dense=13,
    vocab_sizes=CRITEO_1TB_VOCABS,
    embed_dim=128,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
)

SMOKE_CONFIG = DlrmConfig(
    n_dense=13,
    vocab_sizes=(1000, 500, 200, 50, 7),
    embed_dim=16,
    bot_mlp=(32, 16),
    top_mlp=(64, 32, 1),
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="dlrm-mlperf",
        family="recsys",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.RECSYS_SHAPES,
        source="arXiv:1906.00091 (MLPerf)",
    )
)
