"""deepfm [arXiv:1703.04247]: 39 sparse fields (Criteo: 13 bucketised dense +
26 categorical), embed_dim=10, deep MLP 400-400-400, FM interaction (the
port's copy of ``repro/configs/deepfm.py``).  Field vocabulary sized to
Criteo-Kaggle scale (~34M total features)."""
from repro_torch.configs import base
from repro_torch.models.recsys import DeepFmConfig

CONFIG = DeepFmConfig(
    n_fields=39,
    vocab_per_field=871_264,  # 39 * 871,264 ~= 34M one-hot features
    embed_dim=10,
    mlp=(400, 400, 400),
)

SMOKE_CONFIG = DeepFmConfig(
    n_fields=6, vocab_per_field=500, embed_dim=8, mlp=(32, 32)
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="deepfm",
        family="recsys",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=base.RECSYS_SHAPES,
        source="arXiv:1703.04247",
    )
)
