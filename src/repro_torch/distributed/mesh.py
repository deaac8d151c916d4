"""The shard mesh of the distributed MCGI path (the port's counterpart of
the ``jax.sharding.Mesh`` that ``repro.compat.make_mesh`` builds).

The port is single-controller, as the reference is: one process drives
every shard.  A :class:`ShardMesh` names the mesh's axes and sizes and the
one device every shard lives on; shard ``s`` sits at the row-major
coordinates of ``s`` in ``shape`` (the last axis fastest), which is the
order in which the hedged merge composes shard ids.  ``device="meta"``
gives a mesh for shapes only (the dry run's), as
``models.layers.init_device`` does for parameters.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device


class ShardMesh:
    """Axis names and sizes of a shard mesh on one device.

    ``shape[a]`` is the size of axis ``a`` (a dict, in axis order, as the
    reference's ``mesh.shape``); ``n_shards`` their product.
    """

    def __init__(self, shape, axis_names, device="cuda"):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or not shape:
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axis_names}")
        if min(shape) < 1 or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"bad mesh {shape} {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.n_shards = math.prod(shape)
        dev = torch.device(device)
        self.device: torch.device = (dev if dev.type == "meta"
                                     else resolve_device(dev))


def make_mesh(shape, axis_names, device="cuda") -> ShardMesh:
    """A :class:`ShardMesh` of ``shape`` over ``axis_names`` on ``device``
    (the card unless the caller asks for the CPU)."""
    return ShardMesh(shape, axis_names, device)
