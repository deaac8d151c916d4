"""Configurations the port runs: the MCGI datasets
(:mod:`repro_torch.configs.mcgi_datasets`) and the qwen2-7b LM
(:mod:`repro_torch.configs.qwen2_7b`, through :func:`get`)."""
from repro_torch.configs.base import ArchSpec, ShapeCell, get  # noqa: F401
