"""Graph construction and search (port of :mod:`repro.core`)."""
from repro_torch.core.online import build_online_mcgi  # noqa: F401
