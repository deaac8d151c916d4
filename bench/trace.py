"""Reduce a ``torch.profiler`` record of a few window batches to what the
per-layer metrics read.

- ``window_s``: from the first to the last event of the record (host and
  device);
- ``busy_s``: the union of the card's kernel and copy intervals (the
  arithmetic of ``chip_smoke.py::trace_report``);
- ``syncs``: host calls that wait on the card (:data:`SYNC_CALLS`);
- :meth:`Digest.device_seconds`: device time of the kernels whose name
  holds a pattern;
- ``breakdown``: the device operations that took most time, and the idle
  gaps of the card summed by the innermost host operation running at each
  gap's middle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpy")
TOP = 10
# How far back a gap looks for the host operation that covers it.
GAP_LOOKBACK = 4096


@dataclasses.dataclass
class Digest:
    window_s: float
    busy_s: float
    syncs: int
    batches: int
    host_events: int
    device: list          # [(name, start_us, end_us)] of device events
    device_ops: list      # [[name, seconds]] most device time first
    idle_gaps: list       # [[host op, seconds]] most idle time first

    def device_seconds(self, pattern: str) -> float:
        return sum(b - a for name, a, b in self.device if pattern in name) / 1e6


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    return name[:cut] if cut > 0 else name


def _union(spans):
    """(total length, merged [start, end] list) of a set of intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _innermost(host, starts, t: float) -> str:
    """Name of the latest-starting host event that covers ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - GAP_LOOKBACK), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "no host op"


def digest(events, batches: int) -> Digest:
    """``events``: the profiler's ``events()``; ``batches``: the window
    batches completed while it recorded."""
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type.name == "CUDA":
            if b > a:
                device.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    allspans = [(a, b) for _, a, b in device] + [(a, b) for _, a, b in host]
    if not allspans:
        return Digest(0.0, 0.0, 0, batches, 0, [], [], [])
    t0 = min(a for a, _ in allspans)
    t1 = max(b for _, b in allspans)
    busy, merged = _union([(a, b) for _, a, b in device])
    by_op = collections.Counter()
    for name, a, b in device:
        by_op[short_name(name)] += (b - a) / 1e6
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = collections.Counter()
    for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
        gaps[_innermost(host, starts, (e0 + s1) / 2)] += (s1 - e0) / 1e6
    syncs = sum(1 for name, _, _ in host if name in SYNC_CALLS)
    return Digest(
        window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6, syncs=syncs,
        batches=batches, host_events=len(host), device=device,
        device_ops=[[k, v] for k, v in by_op.most_common(TOP)],
        idle_gaps=[[k, v] for k, v in gaps.most_common(TOP)])
