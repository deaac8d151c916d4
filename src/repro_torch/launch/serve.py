"""MCGI serving launcher for the PyTorch port: build an MCGI graph and its
PQ tier, then serve batched queries through the serving engine, reporting
recall@k, QPS, batch latency, mean budget and walk hops.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
        --dataset tiny-mixture --beam 48 --batch 64 --num-batches 20 \\
        [--backend tiered|exact] [--adaptive [--l-min 16] [--l-max 64] \\
         [--lam 0.35] [--buckets auto] [--pipeline] \\
         [--calibrate [--joint] [--recall-target 0.95] [--calib-sample 256]]] \\
        [--filter-frac F]

In-memory modes only: fixed beam, ``--adaptive`` (probe -> budget ->
bucketed continue -> rerank), ``--buckets``, ``--pipeline`` (the
double-buffered stream), ``--calibrate`` (fit ``lam``, and ``hop_factor``
where it binds, to ``--recall-target`` on a held-out sample before serving;
``--joint`` fits ``l_min`` too) and ``--filter-frac`` (per-query namespaces
enforced in-graph).  ``--device cuda`` (default) runs the walk's hops
through the hand-written CUDA kernel; ``--device cpu`` runs the plain
PyTorch hop.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def buckets_arg(value: str):
    """--buckets accepts 'auto' or an integer."""
    if value == "auto":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or an integer, got {value!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dataset", default="tiny-mixture")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the dataset's base set to N points")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="tiered", choices=("tiered", "exact"))
    ap.add_argument("--beam", type=int, default=48)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-batches", type=int, default=10)
    ap.add_argument("--m-pq", type=int, default=8)
    ap.add_argument("--degree", type=int, default=32)
    ap.add_argument("--l-build", type=int, default=64)
    ap.add_argument("--build-batch", type=int, default=256)
    ap.add_argument("--adaptive", action="store_true",
                    help="per-query adaptive beam budgets (Prop. 4.2)")
    ap.add_argument("--l-min", type=int, default=16)
    ap.add_argument("--l-max", type=int, default=None,
                    help="adaptive budget ceiling (default: --beam)")
    ap.add_argument("--lam", type=float, default=0.35)
    ap.add_argument("--buckets", default="auto", type=buckets_arg)
    ap.add_argument("--pipeline", action="store_true",
                    help="double-buffered batch stream (identical results)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit lam to --recall-target on a held-out sample "
                         "before serving")
    ap.add_argument("--joint", action="store_true",
                    help="with --calibrate: fit (lam, l_min) jointly")
    ap.add_argument("--recall-target", type=float, default=0.95)
    ap.add_argument("--calib-sample", type=int, default=256)
    ap.add_argument("--filter-frac", type=float, default=None, metavar="F",
                    help="split the corpus into ~1/F namespaces and enforce "
                         "each query's namespace in-graph")
    args = ap.parse_args(argv)
    if not args.adaptive and (args.calibrate or args.pipeline
                              or (args.buckets != "auto"
                                  and args.buckets > 1)):
        ap.error("--calibrate/--buckets/--pipeline configure the adaptive "
                 "engine; pass --adaptive as well")
    if args.joint and not args.calibrate:
        ap.error("--joint refines --calibrate; pass both")
    if args.filter_frac is not None and not 0.0 < args.filter_frac <= 1.0:
        ap.error("--filter-frac must be in (0, 1]")

    from repro_torch import serving
    from repro_torch.core import build, distance, search
    from repro_torch.data import make_dataset
    from repro_torch.index import build_tiered_index

    dev = args.device
    x, queries = make_dataset(args.dataset, seed=args.seed, device=dev,
                              n=args.n)
    cfg = build.BuildConfig(degree=args.degree, beam_width=args.l_build,
                            batch=args.build_batch)
    t0 = time.time()
    timings: dict = {}
    graph = build.build_mcgi(x, cfg, progress=print, device=dev,
                             timings=timings)
    index = build_tiered_index(x, graph, m_pq=args.m_pq, device=dev)
    print(f"[serve] built index in {time.time() - t0:.1f}s (n={index.n}, "
          + " ".join(f"{k}={v:.1f}s" for k, v in timings.items())
          + f"; fast tier {index.fast_tier_bytes() / 1e6:.1f}MB, "
          f"slow tier {index.slow_tier_bytes() / 1e6:.1f}MB)")
    _, gt_i = distance.brute_force_topk(queries, x, k=args.k)

    budget_cfg = None
    if args.adaptive:
        l_max = args.l_max or args.beam
        budget_cfg = search.AdaptiveBeamBudget(
            l_min=min(args.l_min, l_max), l_max=l_max, lam=args.lam)
    if args.backend == "tiered":
        backend = serving.TieredBackend(index, device=dev)
    else:
        backend = serving.ExactBackend(x, graph.adj, graph.entry, device=dev)
    engine = serving.SearchEngine(backend, budget_cfg, k=args.k,
                                  beam_width=args.beam,
                                  num_buckets=args.buckets)
    if args.calibrate:
        t0 = time.time()
        result = engine.recalibrate(
            queries, gt_i, recall_target=args.recall_target,
            joint=args.joint, sample=args.calib_sample)
        fitted = engine.budget_cfg
        print(f"[serve] calibrated lam={result.lam:.4f} "
              f"l_min={fitted.l_min} hop_factor={result.hop_factor} "
              f"recall={result.recall:.4f} (target {result.target:.2f}, "
              f"{'hit' if result.achieved else 'MISSED'}, "
              f"{len(result.history)} evals, {time.time() - t0:.1f}s)")

    qn = queries.cpu().numpy()
    xn = x.cpu().numpy()
    engine.search(qn[:args.batch])      # warm-up (kernel build on the card)
    rng = np.random.default_rng(0)
    sels = [rng.integers(0, qn.shape[0], args.batch)
            for _ in range(args.num_batches)]
    batches = [qn[s] for s in sels]
    gt = gt_i.cpu().numpy()
    gts = [gt[s] for s in sels]
    masks = None
    if args.filter_frac is not None:
        tenants = max(2, round(1.0 / args.filter_frac))
        ns_rng = np.random.default_rng(1)
        node_ns = ns_rng.integers(0, tenants, size=xn.shape[0])
        masks, gts = [], []
        for qb in batches:
            allowed = node_ns[None, :] == ns_rng.integers(
                0, tenants, size=qb.shape[0])[:, None]
            d2 = distance.squared_l2(torch.as_tensor(qb, device=dev), x)
            d2 = torch.where(torch.as_tensor(allowed, device=dev), d2,
                             torch.inf)
            masks.append(allowed)
            gts.append(torch.argsort(d2, dim=1, stable=True)[:, :args.k]
                       .cpu().numpy())
        print(f"[serve] filtered serving: {tenants} namespaces, masks "
              f"enforced in-graph")

    lat_ms, recalls, hops, budgets = [], [], [], []
    out_of_filter = 0

    def account(res, bi, t0):
        nonlocal out_of_filter
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        recalls.append(float(distance.recall_at_k(
            torch.as_tensor(res.ids), torch.as_tensor(gts[bi]))))
        if masks is not None:
            ids = res.ids
            ok = masks[bi][np.arange(ids.shape[0])[:, None],
                           np.maximum(ids, 0)] | (ids < 0)
            out_of_filter += int((~ok).sum())
        if res.stats is not None:
            hops.append(float(np.mean(res.stats.hops)))
        if res.astats is not None:
            budgets.append(float(np.mean(res.astats.budget)))

    t_all = time.perf_counter()
    if args.pipeline:
        t0 = t_all
        for bi, res in enumerate(engine.search_batches(batches,
                                                       filter=masks)):
            account(res, bi, t0)
            t0 = time.perf_counter()
    else:
        for bi, qb in enumerate(batches):
            t0 = time.perf_counter()
            account(engine.search(qb, filter=None if masks is None
                                  else masks[bi]), bi, t0)
    total = time.perf_counter() - t_all
    if args.pipeline and len(lat_ms) > 1:
        lat_ms = lat_ms[1:]   # the first completion spans the pipeline fill
    extra = f"meanL={np.mean(budgets):.1f} " if budgets else ""
    print(f"[serve] recall@{args.k}={np.mean(recalls):.4f} "
          f"qps={args.batch * args.num_batches / total:.1f} "
          f"hops/query={np.mean(hops):.1f} {extra}"
          f"({'pipelined' if args.pipeline else 'per-batch'}, {dev}) "
          f"batch_lat p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p99={np.percentile(lat_ms, 99):.1f}ms")
    if masks is not None:
        print(f"[serve] filter enforcement: out_of_filter={out_of_filter} "
              f"(in-graph, must be 0)")


if __name__ == "__main__":
    main()
