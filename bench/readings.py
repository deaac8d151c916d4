"""The checks' readings of the program at a cell's own size, sound and with
each fault of ``bench/faults.py`` planted, over many seeds in one process:
the readings that the limits of ``correct`` are set from.

    python3 bench/readings.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--faults <name> ...] [--faulted <k>]

It sets the cell up once (every seed serves the same index), then for each
seed, ``none`` and (on the first ``k`` seeds, default all) each of the
faults named, serves a window of
``seconds`` of the cell's traffic in that seed's order, drains it and
judges it by ``bench/judge.py``.  One JSON line a reading: the seed, the
fault, each check's number, the checks failed, and the work done.  On the
card only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(root, workload: str, seeds, faults, seconds: float, device,
             *, faulted: int | None = None, config: dict | None = None,
             traffic_mix: dict | None = None):
    """Yield one dict a (seed, fault) pair; ``config`` / ``traffic_mix``
    replace the cell's files, for tests at a tiny size."""
    import dataclasses

    from bench import faults as faults_mod
    from bench import harness, judge, spec, traffic

    cell = spec.resolve(root, workload)
    cell = dataclasses.replace(cell, config=config or cell.config,
                               traffic=traffic_mix or cell.traffic)
    x, queries, system = harness.set_up(root, cell, device)
    pool = queries.cpu().numpy()
    gt = None
    for i, seed in enumerate(seeds):
        planted = faults if faulted is None or i < faulted else ()
        for fault in ("none", *planted):
            stream = traffic.batch_indices(pool.shape[0], cell.traffic, seed)
            plant = (contextlib.nullcontext() if fault == "none"
                     else faults_mod.plant(fault))
            try:
                with plant:
                    batches, _, _ = harness._window(
                        system.engine, pool, stream, seconds, None, device)
            except Exception as e:      # a run that crashes is not correct
                yield {"workload": workload, "seed": seed, "fault": fault,
                       "correct": False, "raised": repr(e)}
                continue
            ctx = judge.Context(config=cell.config, x=x, queries=queries,
                                batches=batches, outputs=system.outputs,
                                _gt=gt)
            checks = judge.run_checks(root, ctx)
            gt = ctx._gt
            yield {"workload": workload, "seed": seed, "fault": fault,
                   "correct": all(c["ok"] for c in checks.values()),
                   "readings": {n: c["value"] for n, c in checks.items()},
                   "fails": [n for n, c in checks.items() if not c["ok"]],
                   "batches": len(batches),
                   "work": harness.work_summary(batches, system.outputs)}
    system.engine.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--faulted", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for line in readings(ROOT, args.workload, args.seeds, args.faults,
                         args.seconds, torch.device("cuda", 0),
                         faulted=args.faulted):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
