#!/usr/bin/env python3
"""Phase 2 of chip_smoke.py (every kernel against its plain version at its
path's shapes, each timed) for several checkouts in one call, one child
process a checkout, in the order given:

    python3 chip_phase2_study.py PARENT . . PARENT

Each child builds its checkout's kernels and runs its own chip_smoke.py's
phase-2 checks; it prints one JSON line: the checkout and each kernel
record's device ms a launch (``ms``; ``long_500k`` and the zoo heads of
``decode_attention`` beside it).  Device times on one card compare only
within one call.  Needs one CUDA card.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {src!r})
import torch
import chip_smoke as cs
from repro_torch.kernels import _build, ops
_build.build_all(ops.LIBRARIES)
dev = torch.device("cuda", 0)
cfg = cs.sift1m()
recs = [cs.check_kernel(kind, dev, cs.KERNEL_N, cs.KERNEL_Q, cfg.l_search,
                        cfg.degree, 12, 7 * i)
        for i, kind in enumerate(("exact", "pq"))]
torch.cuda.empty_cache()
recs.append(cs.check_hop_rows(dev, cs.KERNEL_N, cs.KERNEL_Q, cfg.l_search,
                              cfg.degree, 12, 3))
torch.cuda.empty_cache()
recs += cs.check_bulk_kernels(dev, 0)
torch.cuda.empty_cache()
recs.append(cs.check_pq_scan(dev, 0))
torch.cuda.empty_cache()
recs.append(cs.check_decode_attention(dev, 0))
out = {{}}
for r in recs:
    out[r["name"]] = r["ms"]
    for key, sub in r.items():
        if isinstance(sub, dict) and "ms" in sub:
            out[r["name"] + "/" + key] = sub["ms"]
print("PHASE2 " + json.dumps({{"checkout": {root!r}, "ms": out}}))
"""


def main(argv=None) -> int:
    dirs = (argv if argv is not None else sys.argv[1:]) or ["."]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    rc = 0
    for i, d in enumerate(dirs):
        root = os.path.abspath(d)
        code = CHILD.format(root=root, src=os.path.join(root, "src"))
        r = subprocess.run([sys.executable, "-c", code], cwd=root,
                           capture_output=True, text=True)
        with open(os.path.join(out_dir, f"phase2_study_{i}.log"), "w") as f:
            f.write(r.stdout + r.stderr)
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("PHASE2 ")]
        if r.returncode != 0 or not line:
            print(f"[phase2-study] {d}: rc={r.returncode}\n"
                  f"{r.stderr[-2000:]}", flush=True)
            rc = 1
            continue
        print(line[0][len("PHASE2 "):], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
