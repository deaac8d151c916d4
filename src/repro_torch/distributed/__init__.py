"""Distributed MCGI serving (port of :mod:`repro.distributed`): the shard
mesh, sharded scatter-gather search and the hedged top-k merge."""
from repro_torch.distributed.mesh import (  # noqa: F401
    ShardedRows,
    ShardMesh,
    ShardStack,
    make_mesh,
    place_rows,
)
from repro_torch.distributed.sharded_search import (  # noqa: F401
    ShardedIndexSpecs,
    build_sharded_arrays,
    distributed_search,
    make_distributed_continue,
    make_distributed_probe,
    make_distributed_search,
    place_arrays,
    shard_medoids,
    sharded_index_specs,
)
