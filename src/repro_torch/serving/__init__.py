"""Serving engine and host scheduler (port of :mod:`repro.serving`,
in-memory backends)."""
from repro_torch.serving.engine import (  # noqa: F401
    BatchResult, ExactBackend, SearchEngine, TieredBackend)
