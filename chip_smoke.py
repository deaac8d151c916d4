#!/usr/bin/env python3
"""Drive the PyTorch port of MCGI (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases, each printed on its own lines; any failure exits non-zero:

1. device and build — the card's name and power limit (nvidia-smi), then the
   ``beam_step`` CUDA kernel compiled from ``src/repro_torch/csrc`` with nvcc;
2. kernel vs plain version — ``beam_step`` in both kinds at serving shape
   (Q=1024, L=128, R=64, N=1M; D=128 exact, M=16 x K=256 PQ) for 12 hops:
   bit-identical to ``beam_step_ref`` on integer-valued tables and contexts
   (every float32 sum exact in any order), and on float data beam_d within
   1e-5 relative with ids and visited words equal in every lane without a
   near-tie; the device time of one hop, kernel and plain (launches queued
   back to back behind a sleep kernel, so host work is not timed);
3. the main path at the ``mcgi-sift1m`` deployment (the paper's Table 2:
   N=1M, D=128, R=64, L_build=100, alpha in [1, 1.5], l_search=128, k=10,
   max_hops=192, lam=0.25, l_min=8, probe_hops=8, hop_factor=4, PQ m=16) on
   synthetic SIFT1M-shaped data drawn from --seed on the card: MCGI build
   (LID calibration + alpha-mapped prune), PQ tier, ground truth, then
   serving through the engine — tiered adaptive pipelined (the ``pq`` kind),
   exact adaptive (the ``exact`` kind) and one fixed-beam batch at beam 128;
   fails if a kind was never launched, tiered-adaptive recall@10 < 0.80, or
   any result id lies outside [-1, N); after the launch counts are read,
   the tiered adaptive stream is served again as one ``search`` per batch
   and with 4 budget buckets, to compare QPS (results must not move);
4. the kernels line, then one JSON object per the port's contract, and the
   device line last.

Needs one CUDA card; there is no CPU path.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# mcgi-sift1m (paper Table 2/3; the JAX package's configs/mcgi_datasets.py).
SIFT1M = dict(d=128, degree=64, l_build=100, alpha_min=1.0, alpha_max=1.5,
              l_search=128, k=10, max_hops=192, lam=0.25, l_min=8,
              probe_hops=8, hop_factor=4, m_pq=16)
# NVIDIA H100 SXM data sheet, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
RECALL_FLOOR = 0.80
FLOAT_RTOL = 1e-5
KERNEL_N, KERNEL_Q = 1_000_000, 1024     # phase 2: serving shape
N_QUERIES, SERVE_BATCH = 10_000, 1000    # SIFT1M's query set, 10 batches
BUILD_BATCH = 2048                       # walk lanes per build step
SLEEP_CYCLES = 100_000_000               # ~50 ms hold of the card (time_hop)
SOURCE = "src/repro_torch/csrc/beam_step.cu"
REPLACES = "src/repro/kernels/beam_step.py:180"


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2

def walk_problem(kind, dev, n, q, width, r, integer: bool, seed: int,
                 max_hop_limit: int):
    """A random walk problem: dup-free adjacency, every lane entering at its
    own random node (beam slot 0, visited bit set), random budgets and hop
    limits."""
    import torch

    from repro_torch.core import build, search

    g = torch.Generator(device=dev).manual_seed(seed)
    adj = build.random_graph(n, r, g)
    if kind == "exact":
        d = SIFT1M["d"]
        if integer:
            table = torch.randint(-8, 9, (n, d), generator=g, device=dev).float()
            ctxs = torch.randint(-8, 9, (q, d), generator=g, device=dev).float()
        else:
            table = torch.randn((n, d), generator=g, device=dev)
            ctxs = torch.randn((q, d), generator=g, device=dev)
        ev = search._exact_eval(table)
    else:
        m, k = SIFT1M["m_pq"], 256
        table = torch.randint(0, k, (n, m), generator=g, device=dev,
                              dtype=torch.uint8)
        if integer:
            ctxs = torch.randint(0, 64, (q, m, k), generator=g,
                                 device=dev).float()
        else:
            ctxs = torch.rand((q, m, k), generator=g, device=dev) * 64.0
        ev = search._pq_eval(table)
    entries = torch.randint(0, n, (q,), generator=g, device=dev,
                            dtype=torch.int32)
    beam_ids = torch.full((q, width), -1, dtype=torch.int32, device=dev)
    beam_d = torch.full((q, width), torch.inf, device=dev)
    beam_ids[:, 0] = entries
    beam_d[:, 0] = ev(ctxs, entries[:, None], None)[:, 0]
    visited = torch.zeros((q, (n + 31) // 32), dtype=torch.int32, device=dev)
    rows = torch.arange(q, device=dev)
    visited[rows, (entries >> 5).long()] = search._bits(entries)
    state = (beam_ids, beam_d, torch.zeros((q, width), dtype=torch.bool,
                                           device=dev),
             visited, torch.zeros((q,), dtype=torch.int32, device=dev),
             torch.zeros((q,), dtype=torch.int32, device=dev))
    budgets = torch.randint(width // 2, width + 1, (q,), generator=g,
                            device=dev, dtype=torch.int32)
    hop_limits = torch.randint(2, max_hop_limit + 1, (q,), generator=g,
                               device=dev, dtype=torch.int32)
    return state, ctxs, adj, table, budgets, hop_limits


def clone(state):
    return tuple(t.clone() for t in state)


def near_tie(d, rtol: float):
    """(Q,) bool: some two finite beam distances of the lane lie within
    rtol of each other."""
    import torch

    s = torch.sort(d, dim=1).values
    a, b = s[:, :-1], s[:, 1:]
    close = (b - a) <= rtol * b.abs().clamp_min(1e-30)
    return (close & torch.isfinite(b)).any(1)


def time_hop(fn, state0, hold: bool, reps: int = 20,
             rounds: int = 5) -> tuple[float, float]:
    """(device ms, host ms) of one hop from ``state0``: medians over
    ``rounds`` of the mean of ``reps`` calls back to back, each on a clone
    made beforehand.  ``hold``: a sleep kernel queued first holds the card
    until the host has enqueued every call, so the events time the device's
    work alone (raises if the host could not keep ahead).  Without it (the
    plain version, whose host waits on the card inside a call) the events
    span the calls as they ran."""
    import torch

    dev_ms, host_ms = [], []
    for _ in range(rounds):
        states = [clone(state0) for _ in range(reps)]
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(True) for _ in range(3)]
        ev[0].record()
        if hold:
            torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for st in states:
            fn(st)
        host = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if hold and host >= 0.9 * ev[0].elapsed_time(ev[1]):
            raise RuntimeError(f"{reps} calls took {host:.1f} ms of host "
                               f"time, longer than the sleep holding the "
                               f"card; the timing would include host work")
        dev_ms.append(ev[1].elapsed_time(ev[2]) / reps)
        host_ms.append(host / reps)
        del states
    return statistics.median(dev_ms), statistics.median(host_ms)


def hop_bound(kind, state0, state1, ctxs, adj, table, budgets, hop_limits):
    """Least time the card could take for the hop from ``state0`` to
    ``state1``: the larger of the bytes it must move over the HBM rate and
    the operations it must do over the float32 rate (data-dependent: active
    lanes and their valid neighbours as this run's data has them)."""
    from repro_torch.kernels.ref import lane_active

    q, width = state0[0].shape
    r = adj.shape[1]
    active = lane_active(state0[0], state0[2], state0[4], budgets, hop_limits)
    n_act = int(active.sum())
    n_valid = int((state1[5] - state0[5]).sum())
    row = (table.shape[1] * 4 if kind == "exact"
           else table.shape[1] * (1 + 4))        # codes + LUT entries
    ctx = ctxs.shape[1] * 4 if kind == "exact" else 0
    beam = width * (4 + 4 + 1)
    lane_io = 4 * 4 + 2 * 4                      # budget, limit, hops, evals
    nbytes = (q * (beam + lane_io) + n_act * (r * 4 + r * 4 + beam + ctx)
              + n_valid * (row + 4))
    ops = n_valid * (table.shape[1] * 3 if kind == "exact"
                     else table.shape[1]) + n_act * (width + r) ** 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernel(kind, dev, n, q, width, r, hops: int, seed: int):
    """Phase 2 for one kind: bit identity on integer data, tolerance on
    float data, timings and bound.  Returns the kernel's record."""
    import torch

    from repro_torch.kernels import ops, ref

    st0, ctxs, adj, table, budgets, hop_limits = walk_problem(
        kind, dev, n, q, width, r, True, seed, hops)
    st_k, st_p = clone(st0), st0
    for h in range(hops):
        st_k = ops.beam_step(st_k, ctxs, adj, table, budgets, hop_limits,
                             kind=kind)
        st_p = ref.beam_step_ref(st_p, ctxs, adj, table, budgets, hop_limits,
                                 kind=kind)
        sync(dev)
        for name, a, b in zip(("ids", "d", "exp", "visited", "hops", "evals"),
                              st_k, st_p):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(a.shape[0], -1).any(1).sum())
                raise AssertionError(f"beam_step[{kind}] hop {h}: {name} "
                                     f"differs from the plain version in "
                                     f"{bad} lanes (integer data)")
    if not bool((st_p[4] <= hop_limits).all()):
        raise AssertionError("a lane walked past its hop limit")
    log(f"[phase2] beam_step[{kind}] integer data: {hops} hops bit-identical "
        f"(Q={q} L={width} R={r} N={n}; lanes active at the end: "
        f"{int(ref.lane_active(st_p[0], st_p[2], st_p[4], budgets, hop_limits).sum())})")

    # Float data: one hop at a time from the same input state.
    st, ctxs_f, adj_f, table_f, b_f, hl_f = walk_problem(
        kind, dev, n, q, width, r, False, seed + 1, hops)
    max_err, tie_lanes = 0.0, 0
    for h in range(hops):
        a = ops.beam_step(clone(st), ctxs_f, adj_f, table_f, b_f, hl_f,
                          kind=kind)
        b = ref.beam_step_ref(st, ctxs_f, adj_f, table_f, b_f, hl_f,
                              kind=kind)
        same = (a[0] == b[0]).all(1) & (a[3] == b[3]).all(1)
        tie = near_tie(st[1], FLOAT_RTOL) | near_tie(b[1], FLOAT_RTOL)
        if bool((~same & ~tie).any()):
            raise AssertionError(f"beam_step[{kind}] float hop {h}: ids or "
                                 f"visited differ in a lane without a tie")
        fin = torch.isfinite(b[1]) & same[:, None]
        if not torch.equal(torch.isfinite(a[1]) & same[:, None], fin):
            raise AssertionError(f"beam_step[{kind}] float hop {h}: inf "
                                 f"pattern differs")
        err = (a[1] - b[1]).abs()[fin]
        if err.numel():
            if not bool((err <= FLOAT_RTOL * b[1].abs()[fin]).all()):
                raise AssertionError(f"beam_step[{kind}] float hop {h}: "
                                     f"beam_d beyond rtol {FLOAT_RTOL}")
            max_err = max(max_err, float(err.max()))
        tie_lanes += int((~same).sum())
        st = a
    log(f"[phase2] beam_step[{kind}] float data: beam_d within rtol "
        f"{FLOAT_RTOL} (max abs err {max_err:.3g}); {tie_lanes} lane-hops "
        f"differ, each at a near-tie")

    # Timing: one hop of every lane active, from a mid-walk state.
    far = torch.full_like(hop_limits, 1 << 20)
    full = torch.full_like(budgets, width)
    mid = st0
    for _ in range(4):
        mid = ref.beam_step_ref(mid, ctxs, adj, table, full, far, kind=kind)
    nxt = ref.beam_step_ref(mid, ctxs, adj, table, full, far, kind=kind)
    def kernel(s):
        return ops.beam_step(s, ctxs, adj, table, full, far, kind=kind)

    def plain(s):
        return ref.beam_step_ref(s, ctxs, adj, table, full, far, kind=kind)

    for _ in range(3):                                   # warm-up
        kernel(clone(mid))
        plain(mid)
    ms, host_ms = time_hop(kernel, mid, hold=True)
    plain_ms, _ = time_hop(plain, mid, hold=False)
    bound_ms, bound_by = hop_bound(kind, mid, nxt, ctxs, adj, table, full,
                                   far)
    log(f"[phase2] beam_step[{kind}] one hop, {q} lanes: kernel {ms:.4f} ms "
        f"on the device ({host_ms:.4f} ms of wrapper host time per launch), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    del st0, st_k, st_p, st, adj_f, table_f
    return {"name": f"beam_step.{kind}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "verdict": "bit-identical on integer data; float within rtol 1e-5"}


# ---------------------------------------------------------------- phase 3

def serve_run(name, engine, batches, gts, n, pipelined: bool):
    """Serve ``batches``; return the printed metrics."""
    import numpy as np
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    lat, recalls, hops, budgets = [], [], [], []
    t_all = t0 = time.perf_counter()
    results = (engine.search_batches(batches) if pipelined
               else (engine.search(b) for b in batches))
    for bi, res in enumerate(results):
        lat.append((time.perf_counter() - t0) * 1e3)
        if res.ids.shape != (batches[bi].shape[0], engine.k):
            raise AssertionError(f"{name}: result shape {res.ids.shape}")
        if not ((res.ids >= -1) & (res.ids < n)).all():
            raise AssertionError(f"{name}: result id outside [-1, {n})")
        ok = res.ids >= 0
        if not np.isfinite(res.d2[ok]).all():
            raise AssertionError(f"{name}: non-finite distance for a valid id")
        recalls.append(float(distance.recall_at_k(torch.as_tensor(res.ids),
                                                  torch.as_tensor(gts[bi]))))
        hops.append(float(np.mean(res.stats.hops)))
        if res.astats is not None:
            budgets.append(float(np.mean(res.astats.budget)))
        t0 = time.perf_counter()
    total = time.perf_counter() - t_all
    after = ops.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    steady = lat[1:] if pipelined and len(lat) > 1 else lat
    m = dict(recall=float(np.mean(recalls)),
             qps=sum(b.shape[0] for b in batches) / total,
             p50_ms=float(np.percentile(steady, 50)),
             p99_ms=float(np.percentile(steady, 99)),
             mean_budget=float(np.mean(budgets)) if budgets else None,
             mean_hops=float(np.mean(hops)), launches=launches)
    log(f"[serve] {name}: recall@10={m['recall']:.4f} qps={m['qps']:.1f} "
        f"batch_lat p50={m['p50_ms']:.1f}ms p99={m['p99_ms']:.1f}ms "
        f"meanL={m['mean_budget']} hops/query={m['mean_hops']:.2f} "
        f"beam_step launches={launches}")
    return m


def compare_serving(eng_auto, eng_buckets, batches) -> None:
    """QPS and launches of the tiered adaptive stream four ways —
    double-buffered ``search_batches`` or one ``search`` per batch, times
    ``num_buckets="auto"`` (one continue program on the card) or a fixed
    family of 4 budget buckets — each twice, in the order ABCD DCBA.  Every
    way must return the same ids."""
    import numpy as np

    from repro_torch.kernels import ops

    ways = {"pipelined auto": (eng_auto, True),
            "per-batch auto": (eng_auto, False),
            "pipelined 4 buckets": (eng_buckets, True),
            "per-batch 4 buckets": (eng_buckets, False)}
    order = list(ways) + list(reversed(ways))
    qps = {w: [] for w in ways}
    launches = {}
    ids0 = None
    for w in order:
        eng, pipelined = ways[w]
        before = ops.launch_counts()["pq"]
        t0 = time.perf_counter()
        res = list(eng.search_batches(batches) if pipelined
                   else (eng.search(b) for b in batches))
        qps[w].append(sum(b.shape[0] for b in batches)
                      / (time.perf_counter() - t0))
        launches[w] = ops.launch_counts()["pq"] - before
        ids = np.concatenate([r.ids for r in res])
        if ids0 is None:
            ids0 = ids
        elif not np.array_equal(ids, ids0):
            raise AssertionError(f"[compare] {w}: ids differ from "
                                 f"{order[0]}")
    for w, v in qps.items():
        log(f"[compare] tiered adaptive {w}: qps {v[0]:.1f}, {v[1]:.1f}; "
            f"beam_step[pq] launches {launches[w]}")


def main_path(dev, n: int, n_queries: int, batch: int, build_batch: int,
              seed: int):
    import numpy as np
    import torch

    from repro_torch import serving
    from repro_torch.core import build, distance, search
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.index import build_tiered_index
    from repro_torch.kernels import ops

    spec = REGISTRY["sift1m"]
    if n < spec.n:
        log(f"[main] N cut: {spec.n} -> {n} (build must fit the time limit)")
    t0 = time.perf_counter()
    x, queries = make_dataset(spec, seed=seed, device=dev, n=n)
    queries = queries[:n_queries]
    sync(dev)
    log(f"[main] data: N={x.shape[0]} D={x.shape[1]} queries="
        f"{queries.shape[0]} ({time.perf_counter() - t0:.1f}s)")

    ops.reset_launch_counts()
    cfg = build.BuildConfig(degree=SIFT1M["degree"],
                            beam_width=SIFT1M["l_build"],
                            alpha_min=SIFT1M["alpha_min"],
                            alpha_max=SIFT1M["alpha_max"], batch=build_batch,
                            seed=seed)
    timings: dict = {}
    t0 = time.perf_counter()
    graph = build.build_mcgi(x, cfg, progress=lambda m: log(f"[build] {m}"),
                             device=dev, timings=timings)
    t_build = time.perf_counter() - t0
    log(f"[build] MCGI build {t_build:.1f}s (R={cfg.degree} L={cfg.beam_width}"
        f" T={cfg.iters} batch={cfg.batch}): "
        + " ".join(f"{k}={v:.1f}s" for k, v in timings.items())
        + f"; mean out-degree {float(graph.out_degrees().float().mean()):.2f}"
        f"; build launches {ops.launch_counts()}")
    t0 = time.perf_counter()
    index = build_tiered_index(x, graph, m_pq=SIFT1M["m_pq"], device=dev)
    sync(dev)
    log(f"[build] PQ tier m={SIFT1M['m_pq']} in "
        f"{time.perf_counter() - t0:.1f}s (fast tier "
        f"{index.fast_tier_bytes() / 1e6:.1f} MB, slow tier "
        f"{index.slow_tier_bytes() / 1e6:.1f} MB)")
    t0 = time.perf_counter()
    _, gt_i = distance.brute_force_topk(queries, x, k=SIFT1M["k"])
    gt = gt_i.cpu().numpy()
    log(f"[main] ground truth in {time.perf_counter() - t0:.1f}s")

    qn = queries.cpu().numpy()
    batches = [qn[s:s + batch] for s in range(0, qn.shape[0], batch)]
    gts = [gt[s:s + batch] for s in range(0, qn.shape[0], batch)]
    budget = search.AdaptiveBeamBudget(
        l_min=SIFT1M["l_min"], l_max=SIFT1M["l_search"], lam=SIFT1M["lam"],
        probe_hops=SIFT1M["probe_hops"], hop_factor=SIFT1M["hop_factor"])
    tiered = serving.TieredBackend(index, device=dev)
    exact = serving.ExactBackend(x, graph.adj, graph.entry, device=dev)
    eng_t = serving.SearchEngine(tiered, budget, k=SIFT1M["k"])
    eng_e = serving.SearchEngine(exact, budget, k=SIFT1M["k"])
    eng_f = serving.SearchEngine(tiered, None, k=SIFT1M["k"],
                                 beam_width=SIFT1M["l_search"],
                                 max_hops=SIFT1M["max_hops"])
    for eng in (eng_t, eng_e, eng_f):              # warm-up
        eng.search(qn[:64])
    runs = {
        "tiered_adaptive_pipelined": serve_run(
            "tiered adaptive pipelined", eng_t, batches, gts, n, True),
        "exact_adaptive": serve_run("exact adaptive", eng_e, batches, gts, n,
                                    False),
        "tiered_fixed_beam128": serve_run("tiered fixed beam 128", eng_f,
                                          batches[:1], gts[:1], n, False),
    }
    counts = ops.launch_counts()
    log(f"[main] beam_step launches on the main path: {counts}")
    if runs["tiered_adaptive_pipelined"]["launches"]["pq"] == 0:
        raise AssertionError("tiered serving never launched beam_step[pq]")
    if runs["exact_adaptive"]["launches"]["exact"] == 0:
        raise AssertionError("exact serving never launched beam_step[exact]")
    for kind, c in counts.items():
        if c == 0:
            raise AssertionError(f"beam_step[{kind}] was never launched")
    rec = runs["tiered_adaptive_pipelined"]["recall"]
    if rec < RECALL_FLOOR:
        raise AssertionError(f"tiered adaptive recall@10 {rec:.4f} < "
                             f"{RECALL_FLOOR}")
    compare_serving(eng_t, serving.SearchEngine(tiered, budget, k=SIFT1M["k"],
                                                num_buckets=4), batches)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="base points of the main path (1M = SIFT1M; "
                         "a smaller N is printed as a cut)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import beam_step, ops

    dev = torch.device("cuda", 0)
    card = gpu_name_power()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(dev)}")
    t0 = time.perf_counter()
    beam_step.library_path()
    beam_step._library()
    log(f"[build] beam_step kernel built and loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    for line in beam_step.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")

    kernels = [check_kernel(kind, dev, KERNEL_N, KERNEL_Q,
                            SIFT1M["l_search"], SIFT1M["degree"], 12,
                            args.seed + 7 * i)
               for i, kind in enumerate(("exact", "pq"))]
    torch.cuda.empty_cache()

    counts = main_path(dev, args.n, N_QUERIES, SERVE_BATCH, BUILD_BATCH,
                       args.seed)
    for rec in kernels:
        rec["launches"] = counts[rec["name"].split(".")[1]]
    log("kernels: " + json.dumps({r["name"]: {"launches": r["launches"],
                                               "phase2": r["verdict"]}
                                  for r in kernels}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
