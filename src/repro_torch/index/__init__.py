"""Index tiers and conversion (port of :mod:`repro.index`, in-memory half)."""
from repro_torch.index.disk import (  # noqa: F401
    DiskTierModel, InMemorySlowTier, TieredIndex, build_tiered_index,
    search_tiered, search_tiered_adaptive)
