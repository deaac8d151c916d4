"""Configurations the port runs, all registered in
:mod:`repro_torch.configs.base` (:func:`get`, :func:`all_archs`): the MCGI
datasets (:mod:`repro_torch.configs.mcgi_datasets`), the five LM archs
(qwen2-7b, deepseek-coder-33b, minicpm-2b, qwen3-moe-30b-a3b and
deepseek-v2-lite-16b), the four recsys archs (dlrm-mlperf, deepfm, mind and
bert4rec, on ``RECSYS_SHAPES``) and the GNN (gat-cora, four graph
regimes)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchSpec, ShapeCell, all_archs, get)
