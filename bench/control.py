"""The control of the checks: the reference put in the program's place, in
the nearest precision below the configuration's float32 (bfloat16), judged
by the same checks as the program.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed (it draws the PQ training sample) it makes the cell's data,
answers every pool query by the
reference's exact top-k computed in bfloat16 (ids and squared distances),
encodes the vectors in bfloat16 against the codebook the program trains
(``repro_torch.pq.train_pq`` on the data, as ``build_tiered_index`` calls
it), and judges them by ``bench/judge.py``'s own comparison, the configuration's
checks but ``bad_graph_entries`` (the graph is not the control's to make).
It prints one JSON line a seed: each reading, and the checks it fails.  The
control has to come out not correct on every seed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROL_DTYPE = "bfloat16"
NOT_READ = ("bad_graph_entries",)


def control_checks(root, workload: str, seed: int, device,
                   config: dict | None = None) -> dict:
    """``judge.run_checks`` of the bfloat16 control on ``workload``'s
    data: {check: {"value", "limit", "sense", "ok"}}."""
    import numpy as np
    import torch

    from bench import judge, spec
    from bench.reference import knn, pq
    from repro_torch.pq import train_pq

    cfg = config or spec.resolve(root, workload).config
    cfg = dict(cfg, correct={n: r for n, r in cfg["correct"].items()
                             if n not in NOT_READ})
    dtype = getattr(torch, CONTROL_DTYPE)
    data = spec.load_reader(root, "datasets", cfg["data"]["generator"])
    x, queries = data.generate(cfg["data"], device)
    k, m = int(cfg["serve"]["k"]), int(cfg["pq"]["m"])
    ids, d2 = knn.exact_topk(x, queries, k, dtype=dtype)
    idx = np.arange(queries.shape[0])
    batch = judge.Batch(idx=idx, handed=0.0, done=0.0, in_window=True,
                        ids=ids.cpu().numpy().astype(np.int32),
                        d2=d2.float().cpu().numpy())
    width = x.shape[1] + (-x.shape[1]) % m
    book = train_pq(pq.padded(x, width), m=m, seed=seed)
    codes = pq.encode(x, book.centroids, dtype=dtype)
    ctx = judge.Context(config=cfg, x=x, queries=queries, batches=[batch],
                        outputs={"codes": codes.cpu().numpy(),
                                 "centroids": book.centroids.cpu().numpy()})
    return judge.run_checks(root, ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        got = control_checks(ROOT, args.workload, seed,
                             torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": CONTROL_DTYPE,
                          "readings": {n: c["value"] for n, c in got.items()},
                          "fails": [n for n, c in got.items() if not c["ok"]],
                          "correct": all(c["ok"] for c in got.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
