"""Serving engine, host scheduler and front door (port of
:mod:`repro.serving`: the exact and tiered backends, the tiered one over
memory or the disk slow tier, the out-of-core backend, the distributed
backend over a shard mesh, and the admission front door with QoS classes
and deadline hedges)."""
from repro_torch.serving.engine import (  # noqa: F401
    BatchResult, DistributedBackend, ExactBackend, OutOfCoreBackend,
    SearchEngine, TieredBackend)
from repro_torch.serving.server import (  # noqa: F401
    FrontDoor, QoSClass, RequestFuture, ServedResult, ThreadDispatcher,
    VirtualClock, VirtualDispatcher, WallClock, drain_virtual)
