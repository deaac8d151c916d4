#!/usr/bin/env python3
"""``chip_smoke.py``'s [door] phase on several checkouts in one call on one
NVIDIA H100, so that a change's front door is held against its parent's on
the same host.

    python3 chip_door_study.py PARENT . . PARENT    # from the repository root
    python3 chip_door_study.py --n 100000 A B B A   # a shorter build

Each argument is the root of a checkout (its ``chip_smoke.py`` and
``src/``).  For each, in the order given, one child process imports that
checkout's ``chip_smoke.py``, builds its kernels, and runs phase 3
(``main_path``: the ``mcgi-sift1m`` build and serving, 1M points unless
``--n`` says otherwise), phase 3b
(``calibration_path``: the tiered law that [door]'s interactive class
serves) and [door] (``door_path``) with seed 0, as ``chip_smoke.py`` does;
its output goes to ``chiprun_out/door_study_<i>.log``.  Then one JSON line a
child: the replay's ``begin`` p50 a dispatch for each class, the interactive
class's ``begin`` p50 / p99 on the begin thread in each wall-clock run, the
wall-clock door's share of the replay's capacity, the short deadline, the
short-deadline run's statuses and hedged dispatches, the phase's seconds,
and [door]'s verdict (the child's exit code and, if a gate failed, its
message).

Prints the card's name and power limit first; needs one CUDA card.  Exits
1 if a child ended before its [door] lines.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
CHILD_TIMEOUT = 900
RUNS = ("poisson 150%", "poisson 50%", "bursty 50%", "short deadline",
        "held continue")


def child(root: str, n: int) -> int:
    """Phases 3, 3b and [door] of the checkout at ``root``, ``n`` points."""
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    card = cs.gpu_name_power()
    cs.log(f"[study] checkout {root}; {card}")
    _build.build_all(ops.LIBRARIES)
    for lib in ops.LIBRARIES:
        lib.fn()
    _, world = cs.main_path(dev, n, cs.N_QUERIES, cs.SERVE_BATCH,
                            cs.BUILD_BATCH, 0)
    cs.calibration_path(world)
    cs.door_path(world, card, 0)
    cs.log("[study] [door] passed every gate")
    return 0


def _f(pattern: str, text: str):
    m = re.search(pattern, text)
    return float(m.group(1)) if m else None


def summary(log: str, rc: int) -> dict:
    """The numbers of one child's [door] lines."""
    lines = [ln for ln in log.splitlines() if ln.startswith("[door]")]
    text = "\n".join(lines)
    out = {"rc": rc, "door_lines": len(lines)}
    for c in ("interactive", "batch"):
        out[f"replay_begin_p50_ms_{c}"] = _f(
            rf"replay capacity {c}: .*?begin ([\d.]+) ms", text)
    for run in RUNS:
        out[f"begin_thread_ms_p50_p99 {run}"] = [
            _f(rf"\[door\] {re.escape(run)} interactive: .*?begin \(the "
               rf"begin thread\) p50 ([\d.]+) ms", text),
            _f(rf"\[door\] {re.escape(run)} interactive: .*?begin \(the "
               rf"begin thread\) p50 [\d.]+ ms p99 ([\d.]+) ms", text)]
    out["wall_share_of_replay"] = _f(r"lanes/s under overload \(([\d.]+) of",
                                     text)
    out["short_deadline_ms"] = _f(r"short deadline ([\d.]+) ms", text)
    m = re.search(r"\[door\] short deadline interactive: (\{[^}]*\})", text)
    out["short_statuses"] = ast.literal_eval(m.group(1)) if m else None
    out["short_hedged_dispatches"] = _f(
        r"\[door\] short deadline: .*?hedged dispatches (\d+)", text)
    out["phase_s"] = _f(r"\[door\] kernel launches .*?; phase ([\d.]+) s",
                        text)
    fail = [ln for ln in log.splitlines() if ln.startswith("AssertionError")]
    out["verdict"] = "passed" if rc == 0 else (fail[-1] if fail
                                               else f"exit code {rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="base points of phase 3 (1M = SIFT1M)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.n)

    import torch

    if not torch.cuda.is_available():
        print("chip_door_study: no CUDA device; this study runs on the card "
              "only", file=sys.stderr)
        return 2
    if not args.roots:
        ap.error("give the checkouts to run, e.g. PARENT . . PARENT")
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[study] {name.strip()}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    results, bad = [], 0
    for i, root in enumerate(args.roots):
        path = os.path.join(OUT, f"door_study_{i}.log")
        with open(path, "w") as fh:
            try:
                rc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--child",
                     root, "--n", str(args.n)], stdout=fh,
                    stderr=subprocess.STDOUT, timeout=CHILD_TIMEOUT).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        with open(path) as fh:
            res = summary(fh.read(), rc)
        res = {"run": i, "checkout": root, **res}
        bad += res["door_lines"] == 0
        results.append(res)
        print(json.dumps(res), flush=True)
    with open(os.path.join(OUT, "door_study.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
