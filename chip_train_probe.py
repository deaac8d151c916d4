#!/usr/bin/env python3
"""Which batch of minicpm-2b training at train_4k's sequence fits one card,
and which cut of the recsys / GNN zoo's training cells fits it.

    python3 chip_train_probe.py [B ...]      # default: 1 2 4
    python3 chip_train_probe.py --profile B  # where a step's time goes
    python3 chip_train_probe.py --zoo WHAT SIZE [SIZE ...]

Each batch runs in a process of its own, as ``chip_smoke.py``'s
[lm-train] runs it: minicpm-2b at full width and depth, float32 master
weights drawn on the card, bfloat16 compute, remat on, the launcher's WSD
config, S = 4096, three steps through ``make_train_step``.  Prints one
line a batch: the card, then the steps' ms and peak
``max_memory_allocated`` as JSON, or the process's exit code and the last
line it wrote to stderr (an out-of-memory error names the bytes it
asked for).  ``--profile`` runs a fourth step at batch B under
``torch.profiler`` and prints the operators with the most device time
and the device's busy share of the step (the union of its kernels'
intervals over the step's wall time).  ``--zoo`` runs two train steps of
``chip_smoke.py``'s [recsys-*] / [gnn-gat] setup at each SIZE, each in a
process of its own: WHAT ``dlrm`` (SIZE: rows a table above which
dlrm-mlperf's tables are cut), ``mind`` or ``bert4rec`` (SIZE: the batch),
``ogb`` (SIZE: how many times ogb_products' edges are halved).  Needs one
CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 3


def profile_step(step_fn, state, data) -> None:
    """One step under ``torch.profiler``: top operators by device time
    and the device's busy share of the step."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:                     # union of kernel intervals (us)
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    rows = sorted(prof.key_averages(), key=lambda r: -r.device_time_total)
    print(json.dumps({"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
                      "busy_share": busy / 1e3 / wall_ms,
                      "top": [{"op": r.key, "calls": r.count,
                               "device_ms": r.device_time_total / 1e3}
                              for r in rows[:15]]}), flush=True)


def child(b: int, prof: bool = False) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import base

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)             # a context before the stats
    spec = base.get("minicpm-2b")
    torch.cuda.reset_peak_memory_stats(dev)
    state, step_fn, data, sched, _ = cs.train_setup(
        spec, spec.config, dev, 0, 901, cs.TRAIN_STEPS, b)
    state, ms, rows, upd = cs.train_loop(state, step_fn, data, STEPS,
                                         sched, "probe")
    if prof:
        profile_step(step_fn, state, data)
    print(json.dumps({
        "batch": b, "seq": spec.cell(cs.TRAIN_CELL).meta["seq"],
        "step_ms": ms, "update_ms": upd,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "card_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9,
        "losses": [r["loss"] for r in rows]}), flush=True)


ZOO_ARCHS = {"dlrm": "dlrm-mlperf", "mind": "mind", "bert4rec": "bert4rec"}


def zoo_child(what: str, size: int) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import base
    from repro_torch.models import gnn

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)             # a context before the stats
    torch.cuda.reset_peak_memory_stats(dev)
    if what == "ogb":
        meta = base.get("gat-cora").cell("ogb_products").meta
        cfg = base.get("gat-cora").config.for_regime(meta["d_feat"],
                                                     meta["n_classes"])
        batch, _, kept = cs.ogb_graph(0, size)
        rows, ms, _, peak, _ = cs.gat_steps(
            "probe", cfg, gnn.gat_loss, cs.on_device(batch, dev), dev, 0,
            cs.GAT_OPT, 2)
        out = {"edges": kept}
    else:
        _, state, step_fn, data, sched, b, cut = cs.recsys_train_setup(
            ZOO_ARCHS[what], dev, 0, size)
        state, ms, rows, _ = cs.train_loop(state, step_fn, data, 2, sched,
                                           "probe")
        peak = torch.cuda.max_memory_allocated(dev)
        out = {"batch": b, "cut": cut}
    print(json.dumps(dict(out, what=what, size=size, step_ms=ms,
                          peak_gb=peak / 1e9,
                          losses=[r["loss"] for r in rows])), flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--child"]:
        child(int(args[1]), prof=args[2:] == ["--profile"])
        return 0
    if args[:1] == ["--zoo-child"]:
        zoo_child(args[1], int(args[2]))
        return 0
    prof = args[:1] == ["--profile"]
    args = args[1:] if prof else args
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("chip_train_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"[probe] {cs.gpu_name_power()}", flush=True)
    if args[:1] == ["--zoo"]:
        for size in args[2:]:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--zoo-child", args[1], size],
                               capture_output=True, text=True, cwd=ROOT)
            tail = (r.stdout if r.returncode == 0 else r.stderr).strip()
            print(f"[probe] {args[1]} {size}: exit {r.returncode}: "
                  f"{(tail.splitlines() or [''])[-1]}", flush=True)
        return 0
    for b in [int(a) for a in args] or [1, 2, 4]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", str(b)] + ["--profile"] * prof,
                           capture_output=True, text=True, cwd=ROOT)
        if r.returncode == 0:
            for line in r.stdout.strip().splitlines()[-1 - prof:]:
                print(f"[probe] B={b}: {line}", flush=True)
        else:
            err = (r.stderr.strip().splitlines() or [""])[-1]
            print(f"[probe] B={b}: exit {r.returncode}: {err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
