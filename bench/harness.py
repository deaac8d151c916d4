"""One run of one cell: set-up, the measured window, the checks and the
metrics.  :func:`run_cell` does it on any device, so the tests drive it on
the CPU at a tiny size; ``bench/run.py`` is the entry that refuses to run
without the card.

Set-up: the configuration's data set (``bench/datasets/``, one draw fixed
by the configuration's ``data.seed``), the system under test built from it
(``bench/systems/``, with the configuration's own build seed), and
``warmup_batches`` batches of the cell's traffic.  The run's seed draws the
order of the queries only, so every seed gets the same work.  The window:
one client hands ``search_batches`` batches from the traffic stream until
``seconds`` have passed; the batches still in flight are then drained and
judged, but only those back inside the window count in its metrics.  Then
the peak memory is read, the program's state is freed, and the reference
judges every answer (``bench/judge.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import subprocess
import sys
import time

import numpy as np
import torch

from bench import judge, spec, trace, traffic

# Modules that may not be loaded in the process that prints the result,
# compared by whole top-level name (``bench/run.py`` looks once the window
# has closed).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# The window's summary counts the batches done in each slice of this many
# seconds, so a rate that drifts within a run shows apart from one that
# differs between runs.
SLICE_S = 5.0


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: spec.Cell
    seconds: float
    setup_s: float
    ctx: judge.Context
    build_timings: dict
    device_kind: str
    trace: trace.Digest | None = None

    def window_batches(self) -> list:
        return [b for b in self.ctx.batches if b.in_window]

    def traced_batches(self) -> list:
        return [b for b in self.ctx.batches if b.traced]


def forbidden_modules(names) -> list[str]:
    """The names among ``names`` (e.g. ``sys.modules``) whose top-level
    name, compared whole, is JAX's or the JAX package's."""
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


def card_power() -> str:
    """``name, power.limit`` of the card from nvidia-smi (or why not)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi gave nothing ({out.stderr.strip()})"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(engine, pool, stream, seconds: float, tr: dict | None,
            device: torch.device):
    """Serve the window; returns (batches, t0, profiler digest or None)."""
    batches: list[judge.Batch] = []
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def feed():
        while True:
            idx = next(stream)
            if time.perf_counter() >= t_end:
                return
            qb = pool[idx]
            batches.append(judge.Batch(idx=idx, handed=time.perf_counter()))
            yield qb

    prof, digest, recorded = None, None, 0
    for i, res in enumerate(engine.search_batches(feed())):
        now = time.perf_counter()
        b = batches[i]
        b.done, b.in_window = now, now <= t_end
        b.ids, b.d2 = res.ids, res.d2
        b.hops = float(res.stats.hops.sum())
        b.evals = float(res.stats.dist_evals.sum())
        b.budget = float(res.astats.budget.sum())
        if tr is None or digest is not None:
            continue
        if prof is None and i + 1 == tr["skip"]:
            prof = _profiler(device)
            prof.start()
        elif prof is not None:
            recorded += 1
            b.traced = True
            if recorded == tr["batches"]:
                prof.stop()
                digest = trace.digest(prof.events(), recorded)
                log(f"trace: {recorded} batches, {digest.host_events} host "
                    f"and {len(digest.device)} device events over "
                    f"{digest.window_s * 1e3:.3f} ms, device busy "
                    f"{digest.busy_s * 1e3:.3f} ms, {digest.syncs} syncs")
    if prof is not None and digest is None:
        prof.stop()                # the window ended before its batches
    return batches, t0, digest


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _start_profiler_once(device: torch.device) -> None:
    """Start and stop a profiler in set-up: its first start (the tracing
    library's own start-up) took seconds, which would fall in the window."""
    t = time.perf_counter()
    with _profiler(device):
        torch.zeros(1, device=device).add_(1)
        _sync(device)
    log(f"profiler start-up {time.perf_counter() - t:.3f} s (set-up)")


def work_summary(batches, outputs: dict) -> dict:
    """The work the window's batches did (the program's counters, a query
    mean) and digests of the index built in set-up: a change of work shows
    apart from a change of speed."""
    done = [b for b in batches if b.in_window]
    nq = sum(b.idx.shape[0] for b in done) or 1
    out = {n: sum(getattr(b, a) for b in done) / nq for n, a in (
        ("hops_per_query", "hops"), ("evals_per_query", "evals"),
        ("budget_mean", "budget"))}
    for key in ("adj", "codes"):
        if key in outputs:
            out[f"{key}_digest"] = hashlib.blake2b(
                outputs[key].tobytes(), digest_size=8).hexdigest()
    return out


def _window_summary(batches, seconds: float) -> str:
    lat = np.array([(b.done - b.handed) * 1e3 for b in batches
                    if b.in_window])
    done = np.array([b.done for b in batches if b.in_window])
    gaps = np.diff(done) * 1e3 if len(done) > 1 else np.zeros(1)
    if not len(lat):
        return "window: no batch completed"
    t0 = min(b.handed for b in batches)
    slices = np.bincount(((done - t0) // SLICE_S).astype(int))
    return (f"window: {len(lat)} batches in {seconds} s, "
            f"{len(batches) - len(lat)} after it; latency ms p50 "
            f"{np.percentile(lat, 50):.3f} p95 {np.percentile(lat, 95):.3f} "
            f"max {lat.max():.3f}; between results ms p50 "
            f"{np.percentile(gaps, 50):.3f} max {gaps.max():.3f}; batches "
            f"done a {SLICE_S:g} s slice {slices.tolist()}")


def set_up(root, cell: spec.Cell, device: torch.device):
    """(base rows, queries, system under test) of ``cell``."""
    cfg = cell.config
    traffic.check(cell.traffic)
    data = spec.load_reader(root, "datasets", cfg["data"]["generator"])
    x, queries = data.generate(cfg["data"], device)
    system = spec.load_reader(root, "systems", cfg["system"]).build(
        cfg, x, device)
    return x, queries, system


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, *, config: dict | None = None,
             traffic_mix: dict | None = None) -> dict:
    """Run cell ``workload`` of ``root/BENCHMARK.json`` once; returns the
    result line as a dict (``config`` / ``traffic_mix`` replace the cell's
    files, for tests at a tiny size)."""
    cell = spec.resolve(root, workload)
    if config is not None or traffic_mix is not None:
        cell = dataclasses.replace(
            cell, config=config or cell.config,
            traffic=traffic_mix or cell.traffic)
    cfg, mix = cell.config, cell.traffic
    x, queries, system = set_up(root, cell, device)
    pool = queries.cpu().numpy()
    stream = traffic.batch_indices(pool.shape[0], mix, seed)
    warm = [pool[next(stream)] for _ in range(int(mix["warmup_batches"]))]
    for _ in system.engine.search_batches(warm):
        pass
    _sync(device)
    # Set-up's objects out of the collector's way, so its full passes in
    # the window walk only what the window makes.
    gc.collect()
    gc.freeze()

    tr = None
    if traced:
        tr = {"skip": int(mix["trace_skip_batches"]),
              "batches": int(mix["trace_batches"])}
        _start_profiler_once(device)
    batches, t0, digest = _window(system.engine, pool, stream, seconds, tr,
                                  device)
    setup_s = t0 - t_start
    log(_window_summary(batches, seconds))
    work = work_summary(batches, system.outputs)
    log("work: " + ", ".join(f"{k} {v}" for k, v in work.items()))
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    outputs, timings = system.outputs, system.build_timings
    system.engine.close()
    del system
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ctx = judge.Context(config=cfg, x=x, queries=queries, batches=batches,
                        outputs=outputs)
    checks = judge.run_checks(root, ctx)
    run = Run(cell=cell, seconds=seconds, setup_s=setup_s, ctx=ctx,
              build_timings=timings, device_kind=kind, trace=digest)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_reader(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": sum(b.idx.shape[0] for b in batches),
           "failed": int(checks["bad_answers"]["value"])
           if checks.get("bad_answers", {}).get("value") is not None else 0,
           "metrics": metrics, "device": dev}
    if traced and digest is not None:
        dev["busy_s"], dev["window_s"] = digest.busy_s, digest.window_s
        out["breakdown"] = {"device_ops": digest.device_ops,
                            "idle_gaps": digest.idle_gaps}
    out["work"] = work
    out["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                     for n, c in checks.items()}
    out["_check_lines"] = [
        f"check {n}: {c['value']!r} {'<=' if c['sense'] == 'max' else '>='} "
        f"{c['limit']!r} {'ok' if c['ok'] else 'FAILED'}"
        for n, c in checks.items()]
    return out
