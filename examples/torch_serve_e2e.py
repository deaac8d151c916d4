"""End-to-end serving on the PyTorch port: build a disk-resident MCGI index
over ~50k vectors, then serve continuous batched query traffic through a
request batcher and the serving engine (``repro_torch.serving.SearchEngine``
over a ``TieredBackend``), reporting recall / QPS / I/O / modelled-SSD
latency; on the card by default.

    PYTHONPATH=src python examples/torch_serve_e2e.py [--device cpu]
        [--n 50000] [--seconds 15] [--disk PATH]
        [--adaptive [--buckets auto] [--calibrate [--joint]
         [--recall-target 0.95]]]

``--disk PATH`` swaps the in-memory slow tier for a block-aligned store
(one checksummed block per node) written to PATH, served through the
hot-node cache with async prefetch: the same results, and the closing
report prints the cache hit rate and the measured block-read latency next
to the ``DiskTierModel``'s modelled number.

``--adaptive`` serves with per-query beam budgets (Prop. 4.2).
``--calibrate`` fits the budget law's ``lam`` to ``--recall-target`` on a
held-out sample over the deployed two-tier path before traffic starts
(``hop_factor`` doubles if even lam = 0 misses); ``--joint`` fits
(lam, l_min).  ``--buckets`` sets the continue phase's budget buckets:
``auto`` (default), an integer count, or 0/1 for one program; the results
are the same either way.
"""
import argparse
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device, serving
from repro_torch.core import BuildConfig, brute_force_topk, build_mcgi, recall_at_k
from repro_torch.core.search import AdaptiveBeamBudget
from repro_torch.data import synthetic
from repro_torch.index import build_tiered_index
from repro_torch.index.disk import DiskTierModel
from repro_torch.launch.serve import buckets_arg


class RequestBatcher:
    """Production-style micro-batcher: requests queue up; the serving thread
    drains up to ``max_batch`` every ``max_wait_ms``."""

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 5.0):
        self.q: "queue.Queue[tuple[int, float]]" = queue.Queue()
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3

    def submit(self, row: int):
        self.q.put((row, time.perf_counter()))

    def next_batch(self):
        items = []
        deadline = time.perf_counter() + self.max_wait
        while len(items) < self.max_batch:
            try:
                timeout = max(deadline - time.perf_counter(), 0.0)
                items.append(self.q.get(timeout=timeout))
            except queue.Empty:
                break
        return items


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--beam", type=int, default=48)
    ap.add_argument("--offered-qps", type=float, default=500.0)
    ap.add_argument("--disk", default=None, metavar="PATH",
                    help="serve the slow tier from a block-aligned on-disk "
                         "store at PATH (written first if absent)")
    ap.add_argument("--adaptive", action="store_true",
                    help="per-query adaptive beam budgets (l_min=16, "
                         "l_max=--beam)")
    ap.add_argument("--lam", type=float, default=0.35)
    ap.add_argument("--buckets", default="auto", type=buckets_arg,
                    help="continue-phase bucket family: 'auto' "
                         "(histogram-picked, default), an integer count, "
                         "or 0/1 for the single-program path")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit lam (and hop_factor if binding) to "
                         "--recall-target on a held-out sample before "
                         "serving")
    ap.add_argument("--joint", action="store_true",
                    help="with --calibrate: fit (lam, l_min) jointly")
    ap.add_argument("--recall-target", type=float, default=0.95)
    args = ap.parse_args(argv)
    num_buckets = args.buckets
    if not args.adaptive and (args.calibrate or
                              (num_buckets != "auto" and num_buckets > 1)):
        ap.error("--calibrate/--buckets configure the adaptive engine; "
                 "pass --adaptive as well")
    if args.joint and not args.calibrate:
        ap.error("--joint refines --calibrate; pass both")
    dev = resolve_device(args.device)

    spec = dataclasses.replace(synthetic.REGISTRY["sift1b-proxy"], n=args.n,
                               n_queries=1000)
    x, queries = synthetic.make_dataset(spec, seed=0, device=dev)
    print(f"[e2e] corpus {tuple(x.shape)} on {dev}, building index...")
    t0 = time.time()
    graph = build_mcgi(x, BuildConfig(degree=32, beam_width=64, iters=1),
                       progress=print, device=dev)
    index = build_tiered_index(x, graph, m_pq=16, device=dev)
    print(f"[e2e] built in {time.time() - t0:.0f}s | fast tier "
          f"{index.fast_tier_bytes() / 1e6:.0f}MB, slow tier "
          f"{index.slow_tier_bytes() / 1e6:.0f}MB")
    _, gt_ids = brute_force_topk(queries, x, k=10)

    slow_tier = None
    if args.disk:
        import pathlib

        from repro_torch.index import open_or_build_slow_tier

        slow_tier = open_or_build_slow_tier(
            args.disk, index, cache_nodes=4096,
            log=lambda m: print(f"[e2e] {m}"))
        print(f"[e2e] disk slow tier at {args.disk} "
              f"({pathlib.Path(args.disk).stat().st_size / 1e6:.0f}MB, "
              f"block {slow_tier.store.block_size}B)")
    backend = serving.TieredBackend(index, slow_tier=slow_tier, device=dev)
    if args.adaptive:
        budget_cfg = AdaptiveBeamBudget(l_min=min(16, args.beam),
                                        l_max=args.beam, lam=args.lam)
        engine = serving.SearchEngine(backend, budget_cfg, k=10,
                                      num_buckets=num_buckets)
        if args.calibrate:
            result = engine.recalibrate(
                queries, gt_ids, recall_target=args.recall_target,
                joint=args.joint)
            print(f"[e2e] calibrated lam={result.lam:.4f} "
                  f"l_min={engine.budget_cfg.l_min} "
                  f"hop_factor={result.hop_factor} "
                  f"recall={result.recall:.4f} target={result.target:.2f} "
                  f"({'hit' if result.achieved else 'MISSED'})")
    else:
        engine = serving.SearchEngine(backend, None, k=10,
                                      beam_width=args.beam)
    engine.search(queries[:64])  # the first batch's allocations

    batcher = RequestBatcher(max_batch=64)
    stop = threading.Event()
    rng = np.random.default_rng(0)
    qn = queries.cpu().numpy()
    gt = gt_ids.cpu().numpy()

    def traffic():
        period = 1.0 / args.offered_qps
        while not stop.is_set():
            batcher.submit(int(rng.integers(0, qn.shape[0])))
            time.sleep(period)

    t = threading.Thread(target=traffic, daemon=True)
    t.start()

    model = DiskTierModel()
    served, lat, recs, ios = 0, [], [], []
    t_end = time.time() + args.seconds
    try:
        while time.time() < t_end:
            items = batcher.next_batch()
            if not items:
                continue
            idxs = np.array([i for i, _ in items])
            qb = qn[idxs]
            pad = 64 - qb.shape[0]
            # Pad partial batches by cycling real queries, not with zeros:
            # the adaptive engine centres budgets on the batch-mean LID, and
            # a zero vector would skew every real query's budget.
            qb_p = np.pad(qb, ((0, pad), (0, 0)), mode="wrap") if pad else qb
            res = engine.search(qb_p)
            now = time.perf_counter()
            lat.extend((now - s) * 1e3 for _, s in items)
            recs.append(float(recall_at_k(
                torch.from_numpy(res.ids[:len(items)]),
                torch.from_numpy(gt[idxs]))))
            ios.append(float(np.mean(np.asarray(
                res.stats.hops)[:len(items)])))
            served += len(items)
    finally:
        stop.set()
        t.join(timeout=5)
        engine.close()

    out = {"served": served, "qps": served / args.seconds,
           "recall": float(np.mean(recs)) if recs else float("nan"),
           "io": float(np.mean(ios)) if ios else float("nan")}
    print(f"[e2e] served {served} queries in {args.seconds:.0f}s "
          f"({out['qps']:.0f} QPS sustained)")
    ssd_ms = float(model.latency_us(out["io"], rerank_reads=args.beam)) / 1e3
    print(f"[e2e] recall@10={out['recall']:.4f} io/query={out['io']:.1f} "
          f"ssd_model={ssd_ms:.2f}ms")
    if lat:
        print(f"[e2e] e2e latency p50={np.percentile(lat, 50):.1f}ms "
              f"p95={np.percentile(lat, 95):.1f}ms "
              f"p99={np.percentile(lat, 99):.1f}ms")
    if slow_tier is not None:
        st = slow_tier.stats()
        out["hit_rate"] = st["hit_rate"]
        print(f"[e2e] disk tier: hit_rate={st['hit_rate']:.3f} "
              f"blocks_read={st['blocks_read']} "
              f"measured_read={st['measured_read_us']:.1f}us vs "
              f"modelled={model.read_latency_us:.1f}us")
    return out


if __name__ == "__main__":
    main()
