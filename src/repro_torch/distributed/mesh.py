"""The shard mesh of the distributed MCGI path (the port's counterpart of
the ``jax.sharding.Mesh`` that ``repro.compat.make_mesh`` builds).

The port is single-controller, as the reference is: one process drives
every shard.  A :class:`ShardMesh` names the mesh's axes and sizes and the
devices it spans.  Shard ``s`` sits at the row-major coordinates of ``s``
in ``shape`` (the last axis fastest), the order in which the hedged merge
composes shard ids and in which the reference's ``NamedSharding(mesh,
P(axes))`` lays rows over ``mesh.devices.flat``.  The shards are spread
over the devices in contiguous blocks: shard ``s`` lives on device
``s * len(devices) // n_shards``.  On a card every shard has a CUDA stream
of its own there, so the shards' walks overlap, on one card or on several;
``mesh.device``, the first device, is where queries arrive and results
land.

An index on a mesh of several devices is held as :class:`ShardedRows`, one
block of rows a shard on its shard's device; a walk's per-shard state as
:class:`ShardStack`.  ``"cpu"`` gives a one-device mesh (the tests'),
``"meta"`` one for shapes only (the dry run's, as
``models.layers.init_device`` does for parameters).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch import resolve_device

# PyTorch hands out a device's streams round-robin from pools of this many
# (one pool a priority).  The shards take theirs from the high-priority
# pool, which nothing else in the port draws from, so a shard's stream is
# never an engine's; past this many shards on a card, shards share streams.
STREAMS_PER_POOL = 32


def _device(d) -> torch.device:
    """A mesh device: ``meta``, ``cpu`` or a card with its index."""
    dev = torch.device(d)
    if dev.type == "meta":
        return dev
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardMesh:
    """Axis names and sizes of a shard mesh and the devices its shards
    live on.

    ``shape[a]`` is the size of axis ``a`` (a dict, in axis order, as the
    reference's ``mesh.shape``); ``n_shards`` their product.  ``devices``
    are the mesh's devices, ``placement[s]`` the position in ``devices`` of
    shard ``s``'s device and ``shard_devices[s]`` that device;
    ``streams[s]`` is the shard's CUDA stream (None off the card).
    """

    def __init__(self, shape, axis_names, devices=("cuda",)):
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
        if isinstance(devices, (str, torch.device)):
            devices = (devices,)
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices or len(self.devices) > self.n_shards:
            raise ValueError(f"{len(self.devices)} devices for "
                             f"{self.n_shards} shards")
        self.device: torch.device = self.devices[0]
        self.placement = tuple(s * len(self.devices) // self.n_shards
                               for s in range(self.n_shards))
        self.shard_devices = tuple(self.devices[p] for p in self.placement)
        self.streams = tuple(
            torch.cuda.Stream(d, priority=-1) if d.type == "cuda" else None
            for d in self.shard_devices)

    @property
    def spread(self) -> bool:
        """Whether the mesh has more than one device entry: its index is
        then held as :class:`ShardedRows`, not as shard-major tensors."""
        return len(self.devices) > 1

    def caller(self):
        """The caller's stream at the mesh's device (None off the card):
        shard streams wait for it, and it waits for them."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    @contextlib.contextmanager
    def on_shard(self, s: int, after=None):
        """Shard ``s``'s device and stream made current; its stream first
        waits for ``after`` (the caller's stream) without the host
        waiting."""
        st = self.streams[s]
        if st is None:
            yield
            return
        with torch.cuda.device(st.device), torch.cuda.stream(st):
            if after is not None:
                st.wait_stream(after)
            yield

    def to_shard(self, t: torch.Tensor, s: int) -> torch.Tensor:
        """``t`` for work on shard ``s``'s stream (inside :meth:`on_shard`):
        a copy when it lies on another device (ordered after the caller's
        stream), else ``t`` itself, marked as used by the shard's stream so
        the caching allocator does not hand out its block while the walk
        reads it."""
        if t.device != self.shard_devices[s]:
            return t.to(self.shard_devices[s])
        if self.streams[s] is not None:
            t.record_stream(self.streams[s])
        return t

    def to_caller(self, t: torch.Tensor, caller) -> torch.Tensor:
        """A shard's output ``t`` (inside :meth:`on_shard`) on the mesh's
        device for the caller's stream: a copy that the caller's stream
        waits for when the shard is on another card (the reference's
        ``all_gather``), else ``t`` marked as used by the caller's stream
        (which :meth:`join` makes wait for the shard's)."""
        if t.device != self.device:
            return t.to(self.device)
        if caller is not None:
            t.record_stream(caller)
        return t

    def join(self, caller) -> None:
        """The caller's stream waits for the work queued on every shard's
        stream (no host wait)."""
        if caller is None:
            return
        for st in dict.fromkeys(self.streams):
            caller.wait_stream(st)

    def synchronize(self) -> None:
        """The host waits for every card of the mesh (placement and builds,
        never the serving path)."""
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def describe(self) -> str:
        """Where each shard sits, e.g. ``shards 0-3 on cuda:0, 4-7 on
        cuda:1``."""
        blocks = []
        for p, d in enumerate(self.devices):
            mine = [s for s, q in enumerate(self.placement) if q == p]
            blocks.append(f"{mine[0]}-{mine[-1]} on {d}" if len(mine) > 1
                          else f"{mine[0]} on {d}")
        return "shards " + ", ".join(blocks)


def make_mesh(shape, axis_names, devices=None, *, device=None) -> ShardMesh:
    """A :class:`ShardMesh` of ``shape`` over ``axis_names``.

    ``devices`` is a list of devices (the shards spread over them in
    contiguous blocks) or one device (``"cpu"``, ``"meta"``, ``"cuda:0"``:
    a one-device mesh); the default, every visible card (at most one a
    shard).  ``device=`` names one device, as ``devices`` does."""
    if device is not None:
        if devices is not None:
            raise ValueError("give devices or device, not both")
        devices = device
    if devices is None:
        resolve_device("cuda")
        n = min(torch.cuda.device_count(), math.prod(shape))
        devices = [torch.device("cuda", i) for i in range(n)]
    return ShardMesh(shape, axis_names, devices)


class ShardedRows:
    """A shard-major array held as one block of rows a shard, each block on
    its shard's device (the port's ``NamedSharding(mesh, P(axes, None))``).

    Logically the blocks' concatenation: ``shape``, ``dtype``, ``numel`` and
    ``element_size`` describe it; :meth:`gather` builds that one tensor,
    on request only (never on the serving path).
    """

    def __init__(self, parts):
        self.parts = tuple(parts)
        if not self.parts:
            raise ValueError("no shard blocks")

    @property
    def shape(self) -> torch.Size:
        rest = self.parts[0].shape[1:]
        return torch.Size((sum(p.shape[0] for p in self.parts),) + rest)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(p.device for p in self.parts)

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def gather(self, device="cpu") -> torch.Tensor:
        """The shard-major tensor on ``device`` (an explicit gather)."""
        return torch.cat([p.to(device) for p in self.parts])

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def place_rows(mesh: ShardMesh, a, dtype=None) -> ShardedRows:
    """``a``'s shard-major rows placed on ``mesh``: one block a shard on its
    shard's device.  A :class:`ShardedRows` whose blocks sit there already
    comes back as it is; anything else (a tensor, an array) is cut into
    ``n_shards`` blocks and each is copied to its shard's device.  Nothing
    here waits for the copies: call ``mesh.synchronize()`` before a shard's
    stream reads them."""
    n = mesh.n_shards
    if isinstance(a, ShardedRows):
        if len(a.parts) != n:
            raise ValueError(f"{len(a.parts)} shard blocks on a mesh of {n} "
                             f"shards")
        if a.devices == mesh.shard_devices and dtype in (None, a.dtype):
            return a
        blocks = a.parts
    else:
        t = torch.as_tensor(a)
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split into {n} "
                             f"shards")
        per = t.shape[0] // n
        blocks = [t[s * per:(s + 1) * per] for s in range(n)]
    return ShardedRows(b.to(device=d, dtype=dtype or b.dtype)
                       for b, d in zip(blocks, mesh.shard_devices))


class ShardStack:
    """One leaf of a walk state laid out ``(Q, n_shards, ...)``, held as
    each shard's ``(Q, ...)`` block on its device, written on its stream.

    The host schedules on the query axis: :meth:`index_select` (and
    indexing by an index array) selects rows of every block on its shard's
    stream.  :meth:`gather` (``cpu``, ``numpy``, ``np.asarray``) stacks the
    blocks on one device, on request only.
    """

    def __init__(self, mesh: ShardMesh, parts):
        self.mesh = mesh
        self.parts = tuple(parts)

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0]
        return torch.Size((p.shape[0], len(self.parts)) + p.shape[1:])

    def index_select(self, dim: int, index: torch.Tensor) -> "ShardStack":
        if dim != 0:
            raise ValueError("a shard stack is selected on the query axis")
        mesh, caller = self.mesh, self.mesh.caller()
        out = []
        for s, p in enumerate(self.parts):
            with mesh.on_shard(s, after=caller):
                out.append(p.index_select(0, mesh.to_shard(index, s)))
        return ShardStack(mesh, out)

    def __getitem__(self, index) -> "ShardStack":
        if isinstance(index, slice):
            index = torch.arange(self.shape[0])[index]
        return self.index_select(0, torch.as_tensor(index, dtype=torch.long))

    def gather(self, device="cpu") -> torch.Tensor:
        """The ``(Q, n_shards, ...)`` tensor on ``device`` (an explicit
        gather; each block copied on its shard's stream)."""
        blocks = []
        for s, p in enumerate(self.parts):
            with self.mesh.on_shard(s):
                blocks.append(p.to(device))
        return torch.stack(blocks, 1)

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)
