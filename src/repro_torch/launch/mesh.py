"""Production mesh definitions (port of :mod:`repro.launch.mesh`).

The reference lays its cells out on a TPU pod: ``(16, 16)`` over
``("data", "model")``, one shard a device.  The port keeps that shape as a
:class:`~repro_torch.distributed.mesh.ShardMesh`, so the MCGI serve cells
pad ``n`` to the same 256 shards and the dry run's cells carry the
reference's global shapes.  On ``"meta"`` the mesh spans the pod's 256
devices unless ``cards`` names fewer (the dry run's ``--cards``: 256
shards in contiguous blocks over N cards); on a card it spans ``device``
alone, or the first ``cards`` visible cards.  The reference's 2 x 16 x 16
multi-pod mesh has no counterpart here and raises.

Axis semantics (the reference's): ``data`` the batch / FSDP / index-shard
axis, ``model`` the tensor / expert / sequence axis.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.mesh import ShardMesh, make_mesh

POD_DEVICES = 256


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         cards: int | None = None) -> ShardMesh:
    """The reference's single-pod (16, 16) ("data", "model") mesh: on
    ``"meta"`` (the dry run's shapes) over ``cards`` devices (the pod's
    256 by default), else on ``device`` or the first ``cards`` cards."""
    if multi_pod:
        raise ValueError("the 2 x 16 x 16 multi-pod mesh has no counterpart "
                         "in the port")
    if torch.device(device).type == "meta":
        devices = ["meta"] * (cards or POD_DEVICES)
    elif cards:
        devices = [torch.device("cuda", i) for i in range(cards)]
    else:
        devices = device
    return make_mesh((16, 16), ("data", "model"), devices)


def make_host_mesh(n_data: int = 2, n_model: int = 4,
                   device="cuda") -> ShardMesh:
    """The small (n_data, n_model) mesh of the tests, on ``device``."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: ('pod', 'data') or ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def n_devices(mesh) -> int:
    """The mesh's devices (the reference's ``mesh.devices.size``)."""
    return len(mesh.devices)
