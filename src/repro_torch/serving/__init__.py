"""Serving engine and host scheduler (port of :mod:`repro.serving`,
single-host exact and tiered backends, the tiered one over memory or
the disk slow tier)."""
from repro_torch.serving.engine import (  # noqa: F401
    BatchResult, ExactBackend, SearchEngine, TieredBackend)
