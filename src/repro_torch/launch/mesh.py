"""Production mesh definitions (port of :mod:`repro.launch.mesh`).

The reference lays its cells out on a TPU pod: ``(16, 16)`` over
``("data", "model")``.  The port keeps that shape as a
:class:`~repro_torch.distributed.mesh.ShardMesh` on one device, so the
MCGI serve cells pad ``n`` to the same 256 shards and the dry run's cells
carry the reference's global shapes.  Nothing is sharded: every shard lives
on the one device.  The reference's 2 x 16 x 16 multi-pod mesh has no
counterpart on one card and raises.

Axis semantics (the reference's): ``data`` the batch / FSDP / index-shard
axis, ``model`` the tensor / expert / sequence axis.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import ShardMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> ShardMesh:
    """The reference's single-pod (16, 16) ("data", "model") mesh on one
    ``device`` (``"meta"`` for the dry run's shapes)."""
    if multi_pod:
        raise ValueError("the 2 x 16 x 16 multi-pod mesh has no counterpart "
                         "on one card")
    return make_mesh((16, 16), ("data", "model"), device)


def make_host_mesh(n_data: int = 2, n_model: int = 4,
                   device="cuda") -> ShardMesh:
    """The small (n_data, n_model) mesh of the tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: ('pod', 'data') or ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def n_devices(mesh) -> int:
    """The mesh's positions (the reference's device count; here shards of
    one device)."""
    return mesh.n_shards
