"""Index tiers, the block store and serialisation (port of
:mod:`repro.index`, without the out-of-core walk and the delta tier)."""
from repro_torch.index.blockstore import (  # noqa: F401
    BlockChecksumError, BlockStore, BlockStoreError, BlockStoreFormatError,
    BlockStoreTruncatedError, ensure_block_store, write_block_store)
from repro_torch.index.disk import (  # noqa: F401
    BlockSlowTier, DiskTierModel, InMemorySlowTier, SlowTier, TieredIndex,
    build_tiered_index, entry_proximal_ids, open_or_build_slow_tier,
    rerank_with_slow_tier, search_tiered, search_tiered_adaptive)
from repro_torch.index.hot_tier import HotTier  # noqa: F401
from repro_torch.index.serializer import (  # noqa: F401
    load_disk_model, load_index, load_lineage, load_shard_laws,
    load_slow_tier, open_block_store, save_index)
