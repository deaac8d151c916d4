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
         [--freq-decay 0.5]] [--io-workers W]] [--online | --vamana] \\
        [--serve [--qps 200] [--requests 256] [--interactive-frac 0.5] \\
         [--deadline-ms 100] [--batch-deadline-ms 2000] \\
         [--arrival poisson|bursty] [--interactive-recall-target 0.85]] \\
        [--distributed N [--calibrate --per-shard]]

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
read figures.  ``--online`` builds with Online-MCGI (Algorithm 2,
:func:`repro_torch.core.online.build_online_mcgi`) in place of the offline
build, ``--vamana`` the static-alpha baseline (alpha = 1.2).  ``--device
cuda`` (default) runs the walk's hops through the hand-written CUDA kernel;
``--device cpu`` runs the plain PyTorch hop.

``--serve`` (with ``--adaptive``) runs the front door
(:mod:`repro_torch.serving.server`) in place of the batch benchmark: live
requests paced at ``--qps`` (Poisson or bursty ``--arrival``), admitted
into two QoS classes (``--interactive-frac`` splits the mix) with their own
deadlines (``--deadline-ms`` / ``--batch-deadline-ms``) and their own
budget-law engines over the shared backend; with ``--calibrate`` one
(lam, l_min) law per class is fitted to ``--interactive-recall-target`` /
``--recall-target``.  The report is per class: outcome counts, latency
p50 / p99 against the deadline, recall, mean granted budget and walk hops.
Timing runs on the wall-clock seam (``WallClock`` + ``ThreadDispatcher``).

``--distributed N`` splits the dataset into N shards, each with its own
locally built sub-graph (static alpha 1.2) over one PQ codebook, on a
one-axis mesh ``(N,) ("data",)`` over every visible card (the CPU with
``--device cpu``), each shard's rows on its own card, and serves
scatter-gather through a ``DistributedBackend``: staged (probe, host
bucketing, per-bucket continues into the hedged merge) with
``--adaptive``, one monolithic step per batch otherwise.  ``--calibrate
--per-shard`` fits one (lam, l_min) law per shard on shard-local held-out
queries and serves them as runtime tensors.
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


def arrival_times(rng, n: int, qps: float, arrival: str) -> np.ndarray:
    """``n`` arrival times in seconds: Poisson at ``qps``, or bursty
    (on/off-modulated Poisson: 50 ms at 8x ``qps``, then 200 ms at 1/8)."""
    if arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / qps, size=n))
    out, t, on, phase_end = [], 0.0, True, 0.05
    while len(out) < n:
        t += float(rng.exponential(1.0 / (qps * 8.0 if on else qps / 8.0)))
        if t >= phase_end:
            t, on = phase_end, not on
            phase_end += 0.05 if on else 0.2
        else:
            out.append(t)
    return np.asarray(out)


def _distributed_engine(args, x, queries, budget_cfg, cfg):
    """Shard the dataset on a one-axis mesh over the visible cards (the
    launcher's device when it names one, or the CPU) and build the
    distributed serving engine (staged when adaptive; per-shard
    budget laws with --calibrate --per-shard).  Returns (engine, x cut to
    the sharded row count)."""
    from repro_torch import serving
    from repro_torch.core import calibrate
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed import sharded_search as ss

    mesh = make_mesh((args.distributed,), ("data",),
                     None if args.device == "cuda" else args.device)
    n_shards = mesh.n_shards
    t0 = time.time()
    arrays, per = ss.build_sharded_arrays(x, mesh, build_cfg=cfg,
                                          m_pq=args.m_pq, seed=args.seed)
    print(f"[serve] sharded build in {time.time() - t0:.1f}s: "
          f"{per * n_shards} points over {n_shards} shards ({per}/shard); "
          f"{mesh.describe()}")
    shard_laws = None
    if args.calibrate:
        fit = calibrate.calibrate_budget_law_per_shard(
            calibrate.shard_exact_recall_evals(
                arrays["vectors"], arrays["adj"], arrays["entries"], queries,
                n_shards, k=args.k, sample=args.calib_sample, mesh=mesh),
            budget_cfg, recall_target=args.recall_target, n_shards=n_shards)
        shard_laws = fit.law_arrays()
        # hop_factor is global in the step: serve the largest fitted one.
        budget_cfg = fit.serving_budget(budget_cfg)
        print(f"[serve] per-shard laws "
              f"({'hit' if fit.achieved else 'partial'}): "
              f"lam={[round(float(v), 3) for v in shard_laws[0]]} "
              f"l_min={shard_laws[1].tolist()} "
              f"hop_factor={budget_cfg.hop_factor}")
    backend = serving.DistributedBackend(
        mesh, arrays, beam_width=args.beam, max_hops=2048, k=args.k,
        query_chunk=args.batch, beam_budget=budget_cfg,
        budget_buckets=4 if budget_cfg is not None else None,
        shard_laws=shard_laws)
    engine = serving.SearchEngine(backend, budget_cfg, k=args.k,
                                  beam_width=args.beam,
                                  num_buckets=args.buckets)
    return engine, x[:per * n_shards]


def _serve_front_door(args, backend, qn, gt, budget_cfg) -> None:
    """Closed-loop front-door serving on the wall clock: one budget-law
    engine per QoS class over the shared backend, arrival pacing at --qps,
    per-class SLO report."""
    import dataclasses

    from repro_torch import serving
    from repro_torch.core import calibrate

    laws = {"interactive": budget_cfg,
            "batch": dataclasses.replace(budget_cfg,
                                         l_min=budget_cfg.l_max)}
    if args.calibrate:
        def make_eval(cfg):
            return backend.recall_eval(qn, gt, k=args.k,
                                       sample=args.calib_sample, seed=0,
                                       base_cfg=cfg)

        fits = calibrate.calibrate_budget_law_per_class(
            make_eval, budget_cfg,
            {"interactive": args.interactive_recall_target,
             "batch": args.recall_target},
            joint=args.joint)
        laws = calibrate.class_budget_cfgs(fits, budget_cfg)
        for name, r in fits.items():
            print(f"[serve] class {name}: lam={r.lam:.4f} "
                  f"l_min={laws[name].l_min} recall={r.recall:.4f} "
                  f"({'hit' if r.achieved else 'MISSED'} {r.target:.2f})")
    lanes = {"interactive": 8, "batch": 32}
    engines = {name: serving.SearchEngine(backend, law, k=args.k,
                                          num_buckets=args.buckets)
               for name, law in laws.items()}
    classes = [
        serving.QoSClass("interactive", deadline_s=args.deadline_ms / 1e3,
                         batch_window_s=0.002,
                         max_lanes=lanes["interactive"],
                         lane_quantum=lanes["interactive"]),
        serving.QoSClass("batch", deadline_s=args.batch_deadline_ms / 1e3,
                         batch_window_s=0.02, max_lanes=lanes["batch"],
                         lane_quantum=lanes["batch"]),
    ]
    for name, eng in engines.items():      # warm the padded dispatch shape
        eng.search(qn[:lanes[name]])
    rng = np.random.default_rng(0)
    n = args.requests
    arr = arrival_times(rng, n, args.qps, args.arrival)
    rows = rng.integers(0, qn.shape[0], size=n)
    cls_of = ["interactive" if rng.random() < args.interactive_frac
              else "batch" for _ in range(n)]
    door = serving.FrontDoor(engines, classes)
    t0 = time.perf_counter()
    futs = []
    for t_arr, row, cls in zip(arr, rows, cls_of):
        lag = t_arr - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        futs.append((int(row), cls, door.submit(qn[row], cls=cls)))
    door.close(wait=True, timeout=600)
    wall = time.perf_counter() - t0
    print(f"[serve] front door: {n} requests in {wall:.2f}s "
          f"({n / wall:.1f} qps, offered {args.qps:.0f}, "
          f"arrival={args.arrival})")
    for c in classes:
        rs = [(row, f.result(timeout=0)) for row, cls, f in futs
              if cls == c.name]
        lat = [r.latency * 1e3 for _, r in rs if r.status != "shed"]
        ok = [(row, r) for row, r in rs if r.status == "ok"]
        counts: dict[str, int] = {}
        for _, r in rs:
            counts[r.status] = counts.get(r.status, 0) + 1
        rec = (float(np.mean([np.isin(r.ids, gt[row][:args.k]).mean()
                              for row, r in ok])) if ok else float("nan"))
        bud = (float(np.mean([r.budget for _, r in ok
                              if r.budget is not None]))
               if ok else float("nan"))
        hops = (float(np.mean([r.hops for _, r in ok
                               if r.hops is not None]))
                if ok else float("nan"))
        p50 = float(np.percentile(lat, 50)) if lat else float("nan")
        p99 = float(np.percentile(lat, 99)) if lat else float("nan")
        print(f"[serve] class {c.name}: {counts} "
              f"lat p50={p50:.1f}ms p99={p99:.1f}ms "
              f"(deadline {c.deadline_s * 1e3:.0f}ms) "
              f"recall@{args.k}={rec:.4f} meanL={bud:.1f} hops={hops:.1f}")
    st = door.stats()
    print(f"[serve] admission: submitted={st['submitted']} "
          f"admitted={st['admitted']} shed={st['shed']} "
          f"dispatches={st['dispatches']} "
          f"max_open={st['max_open_lanes']}/{door.max_queue}")


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
    ap.add_argument("--online", action="store_true",
                    help="build with Online-MCGI (Algorithm 2)")
    ap.add_argument("--vamana", action="store_true",
                    help="baseline build (static alpha=1.2)")
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
    ap.add_argument("--per-shard", action="store_true",
                    help="with --calibrate --distributed: fit one "
                         "(lam, l_min) law per shard on shard-local "
                         "held-out queries")
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
    ap.add_argument("--serve", action="store_true",
                    help="closed-loop front-door serving (QoS classes, "
                         "deadlines, load shedding) instead of the batch "
                         "benchmark; requires --adaptive")
    ap.add_argument("--qps", type=float, default=200.0,
                    help="with --serve: offered arrival rate")
    ap.add_argument("--requests", type=int, default=256,
                    help="with --serve: total requests to pace in")
    ap.add_argument("--interactive-frac", type=float, default=0.5,
                    help="with --serve: fraction of requests in the "
                         "interactive class (rest are batch)")
    ap.add_argument("--deadline-ms", type=float, default=100.0,
                    help="with --serve: interactive-class deadline")
    ap.add_argument("--batch-deadline-ms", type=float, default=2000.0,
                    help="with --serve: batch-class deadline")
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "bursty"),
                    help="with --serve: arrival process (bursty = on/off "
                         "modulated Poisson)")
    ap.add_argument("--interactive-recall-target", type=float, default=0.85,
                    help="with --serve --calibrate: interactive class's "
                         "recall target (--recall-target is the batch "
                         "class's)")
    ap.add_argument("--distributed", type=int, default=0, metavar="N",
                    help="split the dataset into N shards on the device and "
                         "serve scatter-gather (staged with --adaptive)")
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
    if args.serve and not args.adaptive:
        ap.error("--serve runs per-class budget-law engines (and deadline "
                 "hedges need the staged probe); pass --adaptive")
    if args.serve and args.pipeline:
        ap.error("--pipeline is the batch-stream benchmark mode; --serve "
                 "paces individual requests through the front door")
    if args.serve and args.distributed:
        ap.error("--serve is the single-host front door (the distributed "
                 "backend has no host probe view for deadline partials)")
    if args.per_shard and not (args.calibrate and args.distributed):
        ap.error("--per-shard refines --calibrate for --distributed serving;"
                 " pass all three")
    if args.distributed and args.calibrate and not args.per_shard:
        ap.error("distributed calibration is per-shard (shard geometry "
                 "differs); pass --per-shard")
    if args.filter_frac is not None:
        if not 0.0 < args.filter_frac <= 1.0:
            ap.error("--filter-frac must be in (0, 1]")
        if args.distributed:
            ap.error("--filter-frac is single-host: the filter words are "
                     "indexed by global node id, which the sharded walk "
                     "has no view of")
        if args.serve:
            ap.error("--filter-frac drives the batch benchmark; the front "
                     "door paces unfiltered requests")
    if args.distributed and (args.index or args.online or args.vamana):
        ap.error("--distributed builds per-shard sub-graphs in process; "
                 "--index/--online/--vamana apply to single-host serving")
    if args.distributed and args.disk:
        ap.error("--disk is the single-host out-of-core slow tier; the "
                 "distributed path keeps per-shard slow tiers in memory")
    if args.distributed and args.backend != "tiered":
        ap.error("--distributed serves PQ-routed shards (the tiered "
                 "backend); --backend exact is single-host")

    from repro_torch import serving
    from repro_torch.core import build, distance, online, search
    from repro_torch.data import make_dataset
    from repro_torch.index import (DiskTierModel, build_tiered_index,
                                   load_index, open_or_build_slow_tier,
                                   save_index)

    dev = args.device
    x, queries = make_dataset(args.dataset, seed=args.seed, device=dev,
                              n=args.n)
    cfg = build.BuildConfig(degree=args.degree, beam_width=args.l_build,
                            batch=args.build_batch)
    budget_cfg = None
    if args.adaptive:
        l_max = args.l_max or args.beam
        budget_cfg = search.AdaptiveBeamBudget(
            l_min=min(args.l_min, l_max), l_max=l_max, lam=args.lam)
    if args.distributed:
        engine, x = _distributed_engine(args, x, queries, budget_cfg, cfg)
        _, gt_i = distance.brute_force_topk(queries, x, k=args.k)
        _serve_batches(args, engine, x, queries, gt_i)
        return
    if args.index and pathlib.Path(args.index).exists():
        index = load_index(args.index, device=dev)
        graph = index.graph
        print(f"[serve] loaded index: n={index.n}")
    else:
        t0 = time.time()
        timings: dict = {}
        if args.online:
            graph = online.build_online_mcgi(x, cfg, progress=print,
                                             device=dev, timings=timings)
        elif args.vamana:
            graph = build.build_vamana(x, 1.2, cfg, progress=print,
                                       device=dev)
        else:
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
    if args.serve:
        _serve_front_door(args, backend, queries.cpu().numpy(),
                          gt_i.cpu().numpy(), budget_cfg)
        if args.disk:
            _report_disk_tier(backend, DiskTierModel())
        return
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
    _serve_batches(args, engine, x, queries, gt_i)
    if args.disk:
        _report_disk_tier(backend, DiskTierModel())


def _serve_batches(args, engine, x, queries, gt_i) -> None:
    """The batch benchmark: ``--num-batches`` random batches, per batch or
    pipelined, with the report line; closes the engine."""
    from repro_torch.core import distance

    dev = args.device
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
    # The monolithic distributed step reports no hop counters.
    io_part = f"hops/query={np.mean(hops):.1f} " if hops else ""
    print(f"[serve] recall@{args.k}={np.mean(recalls):.4f} "
          f"qps={args.batch * args.num_batches / total:.1f} "
          f"{io_part}{extra}"
          f"({'pipelined' if args.pipeline else 'per-batch'}, {dev}) "
          f"batch_lat p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p99={np.percentile(lat_ms, 99):.1f}ms")
    if masks is not None:
        print(f"[serve] filter enforcement: out_of_filter={out_of_filter} "
              f"(in-graph, must be 0)")
    engine.close()


if __name__ == "__main__":
    main()
