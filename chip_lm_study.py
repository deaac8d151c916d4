#!/usr/bin/env python3
"""``chip_smoke.py``'s LM serving paths (phase 4 up to the training
phases) on several checkouts in one call on one NVIDIA H100, so that a
change's decode steps are held against its parent's on the same host.

    python3 chip_lm_study.py PARENT . . PARENT    # from the repository root

Each argument is the root of a checkout (its ``chip_smoke.py`` and
``src/``).  For each, in the order given, one child process imports that
checkout's ``chip_smoke.py``, builds its kernels and runs ``lm_paths``
with seed 0, as ``chip_smoke.py`` does; its output goes to
``chiprun_out/lm_study_<i>.log``.  Every checkout runs at the same
shapes: where a checkout's smoke cuts [lm-serve] for time
(``SERVE_PROMPT`` / ``SERVE_GEN``), the child sets it back to 8 prompts
of ``LM_PROMPT`` tokens, greedy to ``LM_GEN``.  Then one JSON line a
child: each path's step p50 / p99 ms, the phase seconds and the child's
exit code.

Prints the card's name and power limit first; needs one CUDA card.  Exits
1 if a child failed.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
CHILD_TIMEOUT = 600


def child(root: str) -> int:
    """``lm_paths`` of the checkout at ``root``, at the uncut shapes."""
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    if hasattr(cs, "SERVE_PROMPT"):
        cs.SERVE_PROMPT, cs.SERVE_GEN = cs.LM_PROMPT, cs.LM_GEN
        cs.SERVE_CHECK_STEPS = cs.LM_CHECK_STEPS
    dev = torch.device("cuda", 0)
    cs.log(f"[study] checkout {root}; {cs.gpu_name_power()}")
    _build.build_all(ops.LIBRARIES)
    for lib in ops.LIBRARIES:
        lib.fn()
    cs.lm_paths(dev, 0)
    cs.log("[study] the LM paths passed every gate")
    return 0


def summary(log: str, rc: int) -> dict:
    """Step p50 / p99 of every LM path, and each model's phase seconds."""
    out = {"rc": rc}
    for m in re.finditer(r"^\[(lm-[\w-]+)\] .*?(?:step )?p50 ([\d.]+) ms, "
                         r"p99 ([\d.]+) ms", log, re.M):
        out[m.group(1)] = [float(m.group(2)), float(m.group(3))]
    for m in re.finditer(r"^\[(lm-[\w]+)\] phase ([\d.]+) s", log, re.M):
        out[f"{m.group(1)} phase_s"] = float(m.group(2))
    fail = [ln for ln in log.splitlines() if ln.startswith(
        ("AssertionError", "RuntimeError", "torch.OutOfMemoryError"))]
    out["verdict"] = "passed" if rc == 0 else (fail[-1] if fail
                                               else f"exit code {rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)

    import torch

    if not torch.cuda.is_available():
        print("chip_lm_study: no CUDA device; this study runs on the card "
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
        path = os.path.join(OUT, f"lm_study_{i}.log")
        with open(path, "w") as fh:
            try:
                rc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--child",
                     root], stdout=fh, stderr=subprocess.STDOUT,
                    timeout=CHILD_TIMEOUT).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        with open(path) as fh:
            res = {"run": i, "checkout": root, **summary(fh.read(), rc)}
        bad += rc != 0
        results.append(res)
        print(json.dumps(res), flush=True)
    with open(os.path.join(OUT, "lm_study.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
