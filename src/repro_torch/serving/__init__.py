"""Serving engine and host scheduler (port of :mod:`repro.serving`,
single-host: the exact and tiered backends, the tiered one over memory or
the disk slow tier, and the out-of-core backend)."""
from repro_torch.serving.engine import (  # noqa: F401
    BatchResult, ExactBackend, OutOfCoreBackend, SearchEngine, TieredBackend)
