"""Carry an index built elsewhere into the port.

The arrays are plain numpy, keyed by the reference's dataclass field names
(``adj``, ``entry``, ``alpha``, ``lid``, ``mu``, ``sigma`` for the graph;
``centroids``, ``codes``, ``vectors`` for the tiers; the sharded index's
``adj``, ``codes``, ``vectors``, ``centroids``, ``entries``), so the port
never imports the package that built them.  uint32 data keeps its bit
pattern as int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.types import GraphIndex
from repro_torch.index.disk import TieredIndex
from repro_torch.pq import PqCodebook


def _tensor(a, dtype: np.dtype, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def graph_index_from_arrays(arrays: dict, device="cuda") -> GraphIndex:
    dev = resolve_device(device)
    f32 = np.float32
    return GraphIndex(adj=_tensor(arrays["adj"], np.int32, dev),
                      entry=_tensor(arrays["entry"], np.int32, dev).reshape(()),
                      alpha=_tensor(arrays["alpha"], f32, dev),
                      lid=_tensor(arrays["lid"], f32, dev),
                      mu=_tensor(arrays["mu"], f32, dev).reshape(()),
                      sigma=_tensor(arrays["sigma"], f32, dev).reshape(()))


def tiered_index_from_arrays(arrays: dict, device="cuda") -> TieredIndex:
    dev = resolve_device(device)
    return TieredIndex(
        graph=graph_index_from_arrays(arrays, dev),
        codebook=PqCodebook(_tensor(arrays["centroids"], np.float32, dev)),
        codes=_tensor(arrays["codes"], np.uint8, dev),
        vectors=_tensor(arrays["vectors"], np.float32, dev))


def sharded_arrays_from_arrays(arrays: dict, device="cuda") -> dict:
    """A distributed index (the dict of
    :func:`repro_torch.distributed.sharded_search.build_sharded_arrays`)
    from numpy arrays of the same keys, shard-major; ``entries`` is
    optional.  ``device`` is one device (shard-major tensors there) or a
    :class:`~repro_torch.distributed.mesh.ShardMesh`: each shard's rows are
    then placed on its own device
    (:func:`~repro_torch.distributed.sharded_search.place_arrays`)."""
    dtypes = {"adj": np.int32, "codes": np.uint8, "vectors": np.float32,
              "centroids": np.float32, "entries": np.int32}
    if hasattr(device, "shard_devices"):          # a ShardMesh
        from repro_torch.distributed.sharded_search import place_arrays

        return place_arrays(device, {
            name: _tensor(arrays[name], dt, "cpu")
            for name, dt in dtypes.items() if name in arrays})
    dev = resolve_device(device)
    return {name: _tensor(arrays[name], dt, dev)
            for name, dt in dtypes.items() if name in arrays}
