"""MCGI serving launcher for the PyTorch port: build an MCGI graph and its
PQ tier, then serve batched queries through the serving engine, reporting
recall@k, QPS, batch latency, mean budget and walk hops.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
        --dataset tiny-mixture --beam 48 --batch 64 --num-batches 20 \\
        [--backend tiered|exact] [--adaptive [--l-min 16] [--l-max 64] \\
         [--lam 0.35] [--buckets auto] [--pipeline] \\
         [--calibrate [--joint] [--recall-target 0.95] [--calib-sample 256]]] \\
        [--filter-frac F] [--index I] [--disk D [--cache-nodes 4096] \\
         [--pin-nodes 256] [--hot-nodes 0 [--hot-chunk 256] \\
         [--freq-decay 0.5]] [--io-workers W]]

Modes: fixed beam, ``--adaptive`` (probe -> budget ->
bucketed continue -> rerank), ``--buckets``, ``--pipeline`` (the
double-buffered stream), ``--calibrate`` (fit ``lam``, and ``hop_factor``
where it binds, to ``--recall-target`` on a held-out sample before serving;
``--joint`` fits ``l_min`` too) and ``--filter-frac`` (per-query namespaces
enforced in-graph).  ``--index I`` loads the index from I, or builds it
and saves it there; ``--disk D`` serves the tiered backend's slow tier from
a block store at D (written first when absent, unreadable or stale; the
same results, real block reads, a prefetch stage in the adaptive
pipeline) and ends with a ``[serve] disk tier:`` line of measured cache and
read figures.  ``--device cuda`` (default) runs the walk's hops
through the hand-written CUDA kernel; ``--device cpu`` runs the plain
PyTorch hop.
"""
from __future__ import annotations

import argparse
import pathlib
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


def _report_disk_tier(backend, model) -> None:
    """Measured slow-tier figures beside the DiskTierModel's modelled read
    latency (the stats stay readable after the engine is closed)."""
    st = backend.slow_tier.stats()
    lat = backend.slow_tier.fetch_latency_us()
    print(f"[serve] disk tier: hit_rate={st['hit_rate']:.3f} "
          f"(hits={st['cache_hits']} misses={st['cache_misses']}) "
          f"blocks_read={st['blocks_read']} "
          f"measured_read={st['measured_read_us']:.1f}us vs "
          f"modelled={model.read_latency_us:.1f}us "
          f"fetch p50={lat['fetch_p50_us']:.0f}us "
          f"p99={lat['fetch_p99_us']:.0f}us")
    if "hot_capacity" in st:
        print(f"[serve] hot tier: resident={st['hot_nodes']}"
              f"/{st['hot_capacity']} hot_hits={st['hot_hits']} "
              f"promotions={st['promotions']} "
              f"demotions={st['demotions']} "
              f"ticks={st['promotion_ticks']} "
              f"promotion_io_blocks={st['promotion_io_blocks']}")


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
    ap.add_argument("--index", default=None,
                    help="load the index from this path, or build it and "
                         "save it there")
    ap.add_argument("--disk", default=None, metavar="PATH",
                    help="serve the slow tier from a block store at PATH "
                         "(written there first if absent or stale)")
    ap.add_argument("--cache-nodes", type=int, default=4096,
                    help="with --disk: record LRU capacity")
    ap.add_argument("--pin-nodes", type=int, default=256,
                    help="with --disk: pinned entry-proximal nodes (0: none)")
    ap.add_argument("--hot-nodes", type=int, default=0,
                    help="with --disk: hot-tier capacity (0 disables it)")
    ap.add_argument("--hot-chunk", type=int, default=256,
                    help="with --hot-nodes: most promotions per tick")
    ap.add_argument("--freq-decay", type=float, default=0.5,
                    help="with --hot-nodes: per-tick decay of the access "
                         "frequencies")
    ap.add_argument("--io-workers", type=int, default=None,
                    help="with --disk: prefetch worker threads (default 1)")
    args = ap.parse_args(argv)
    if args.disk and args.backend != "tiered":
        ap.error("--disk serves the tiered backend's slow tier")
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
    from repro_torch.index import (DiskTierModel, build_tiered_index,
                                   load_index, open_or_build_slow_tier,
                                   save_index)

    dev = args.device
    x, queries = make_dataset(args.dataset, seed=args.seed, device=dev,
                              n=args.n)
    if args.index and pathlib.Path(args.index).exists():
        index = load_index(args.index, device=dev)
        graph = index.graph
        print(f"[serve] loaded index: n={index.n}")
    else:
        cfg = build.BuildConfig(degree=args.degree, beam_width=args.l_build,
                                batch=args.build_batch)
        t0 = time.time()
        timings: dict = {}
        graph = build.build_mcgi(x, cfg, progress=print, device=dev,
                                 timings=timings)
        index = build_tiered_index(x, graph, m_pq=args.m_pq, device=dev)
        print(f"[serve] built index in {time.time() - t0:.1f}s "
              f"(n={index.n}, "
              + " ".join(f"{k}={v:.1f}s" for k, v in timings.items())
              + f"; fast tier {index.fast_tier_bytes() / 1e6:.1f}MB, "
              f"slow tier {index.slow_tier_bytes() / 1e6:.1f}MB)")
        if args.index:
            save_index(args.index, index)
    _, gt_i = distance.brute_force_topk(queries, x, k=args.k)

    budget_cfg = None
    if args.adaptive:
        l_max = args.l_max or args.beam
        budget_cfg = search.AdaptiveBeamBudget(
            l_min=min(args.l_min, l_max), l_max=l_max, lam=args.lam)
    slow_tier = None
    if args.disk:
        slow_tier = open_or_build_slow_tier(
            args.disk, index, cache_nodes=args.cache_nodes,
            pin_nodes=args.pin_nodes, io_workers=args.io_workers,
            hot_nodes=args.hot_nodes, hot_chunk=args.hot_chunk,
            freq_decay=args.freq_decay, log=lambda m: print(f"[serve] {m}"))
        hot_part = (f" hot={args.hot_nodes} (chunk={args.hot_chunk} "
                    f"decay={args.freq_decay})" if args.hot_nodes else "")
        print(f"[serve] disk slow tier: n={slow_tier.store.n} "
              f"block={slow_tier.store.block_size}B "
              f"pinned={slow_tier.stats()['pinned_nodes']}" + hot_part)
    if args.backend == "tiered":
        backend = serving.TieredBackend(index, slow_tier=slow_tier,
                                        device=dev)
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
    engine.close()
    if args.disk:
        _report_disk_tier(backend, DiskTierModel())


if __name__ == "__main__":
    main()
