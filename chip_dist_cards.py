#!/usr/bin/env python3
"""[dist] over every visible card, without the rest of the smoke: the gpu
tests of ``tests/test_torch_distributed.py`` (two of them need two cards
or more), then ``chip_smoke.dist_path`` over phase 3's data (the 1M
SIFT1M-shaped rows and 10,000 queries drawn from seed 0, ground truth by
``brute_force_topk``; no MCGI build, which [dist] does not read).

    python3 chip_dist_cards.py [--n N]        # e.g. on a host with four H100s

It prints the test summary, the number of cards and each [dist] line
(the cards, each shard's card and the GB on each, every gate, the serving
figures), and exits non-zero if a test or a gate fails.  Needs a card.
"""
import argparse
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                        "--noconftest", "-x", "-p", "no:cacheprovider",
                        "tests/test_torch_distributed.py"],
                       cwd=ROOT, env=env, capture_output=True, text=True)
    print(r.stdout[-6000:], r.stderr[-3000:], flush=True)
    print(f"[cards] gpu tests rc={r.returncode} in {time.time() - t0:.1f}s",
          flush=True)

    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.core import distance
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.kernels import _build, ops

    _build.build_all(ops.LIBRARIES)
    dev = torch.device("cuda", 0)
    card = cs.gpu_name_power()
    print(f"[cards] {torch.cuda.device_count()} cards; {card}", flush=True)
    x, queries = make_dataset(REGISTRY["sift1m"], seed=0, device=dev,
                              n=args.n)
    queries = queries[:cs.N_QUERIES]
    _, gt = distance.brute_force_topk(queries, x, k=10)
    qn, gt = queries.cpu().numpy(), gt.cpu().numpy()
    b = cs.SERVE_BATCH
    # [dist] reads phase 3's rows, batches and ground truth only.
    world = {"tiered": types.SimpleNamespace(
                 index=types.SimpleNamespace(vectors=x)),
             "qn": qn,
             "batches": [qn[i:i + b] for i in range(0, qn.shape[0], b)],
             "gts": [gt[i:i + b] for i in range(0, qn.shape[0], b)]}
    t0 = time.time()
    cs.dist_path(world, card, 0)
    print(f"[cards] dist {time.time() - t0:.1f}s", flush=True)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
