"""Serving engine, host scheduler and front door (port of
:mod:`repro.serving`, single-host: the exact and tiered backends, the
tiered one over memory or the disk slow tier, the out-of-core backend, and
the admission front door with QoS classes and deadline hedges)."""
from repro_torch.serving.engine import (  # noqa: F401
    BatchResult, ExactBackend, OutOfCoreBackend, SearchEngine, TieredBackend)
from repro_torch.serving.server import (  # noqa: F401
    FrontDoor, QoSClass, RequestFuture, ServedResult, ThreadDispatcher,
    VirtualClock, VirtualDispatcher, WallClock, drain_virtual)
