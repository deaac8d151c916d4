#!/usr/bin/env python3
"""Drive the PyTorch port of MCGI (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases, each printed on its own lines; any failure exits non-zero:

1. device and build — the card's name and power limit (nvidia-smi), then the
   four kernel libraries (``beam_step``, ``l2_distance``, ``topk``,
   ``lid_kernel``) compiled from ``src/repro_torch/csrc`` with nvcc, one
   process each, all started together;
2. kernel vs plain version, at the main path's own shapes —
   ``beam_step`` in both kinds at serving shape (Q=1024, L=128, R=64, N=1M;
   D=128 exact, M=16 x K=256 PQ) for 12 hops: bit-identical to
   ``beam_step_ref`` on integer-valued tables and contexts, and on float data
   beam_d within 1e-5 relative with ids and visited words equal in every
   lane without a near-tie; ``l2_distance`` at the k-NN shape (4096 x 65536
   x 128) float32 within rtol 1e-4 / atol 1e-3, bfloat16 at 1024 x 8192 x
   128 within 2e-2 / 2e-1; ``topk`` on that float32 output at k = 17 and 10
   (and on a row with planted ties, a row with fewer than k finite entries
   and 8 rows cut into segments): values bitwise and ids exactly equal;
   ``lid_estimate`` at 1M x 16 within rtol 1e-4.  Each kernel's device time
   per launch (launches queued back to back behind a sleep kernel, so host
   work is not timed), the plain version's time, the library call's time
   where one PyTorch call computes the same function, and the bound;
3. the main path at the ``mcgi-sift1m`` deployment (the paper's Table 2,
   ``repro_torch/configs/mcgi_datasets.py``: N=1M, D=128, R=64,
   L_build=100, alpha in [1, 1.5], l_search=128, k=10, max_hops=192,
   lam=0.25, l_min=8, probe_hops=8, hop_factor=4; PQ m=16) on synthetic
   SIFT1M-shaped data drawn from --seed on the card: MCGI build (the LID
   k-NN through ``l2_distance`` + ``topk``, the estimate through
   ``lid_estimate``, then the alpha-mapped prune), PQ tier, ground truth,
   then serving through the engine — tiered adaptive pipelined (the ``pq``
   kind), exact adaptive (the ``exact`` kind) and one fixed-beam batch at
   beam 128; fails if any of the five kernels was never launched,
   tiered-adaptive recall@10 < 0.80, or any result id lies outside [-1, N);
   after the launch counts are read, the tiered adaptive stream is served
   again as one ``search`` per batch and with 4 budget buckets, to compare
   QPS (results must not move);
3b. the calibration path — ``SearchEngine.recalibrate(joint=True)`` of the
   exact adaptive engine to the config's recall target 0.95 and of the
   tiered engine to 0.80 (PQ m=16 caps tiered recall near 0.835), each on
   256 held-out queries, then the 10k stream served with each fitted law;
   fails if the exact fit is not achieved, its served recall@10 falls below
   0.92, or a ``beam_step`` kind was never launched;
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

# NVIDIA H100 SXM data sheet, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
RECALL_FLOOR = 0.80
FLOAT_RTOL = 1e-5
KERNEL_N, KERNEL_Q = 1_000_000, 1024     # phase 2: serving shape
KNN_Q, KNN_N = 4096, 65536               # phase 2: one k-NN chunk
N_QUERIES, SERVE_BATCH = 10_000, 1000    # SIFT1M's query set, 10 batches
BUILD_BATCH = 2048                       # walk lanes per build step
M_PQ = 16                                # the config's m_pq is None (no PQ)
TIERED_TARGET = 0.80                     # PQ m=16 caps tiered recall ~0.835
SERVED_RECALL_SLACK = 0.03
CALIB_SAMPLE = 256
SLEEP_CYCLES = 100_000_000               # ~50 ms hold of the card (timing)
CSRC = "src/repro_torch/csrc/"
REPLACES = {"beam_step": "src/repro/kernels/beam_step.py:180",
            "l2_distance": "src/repro/kernels/l2_distance.py:38",
            "topk": "src/repro/kernels/topk.py:45",
            "lid_estimate": "src/repro/kernels/lid_kernel.py:36"}
SOURCES = {"beam_step": "beam_step.cu", "l2_distance": "l2_distance.cu",
           "topk": "topk.cu", "lid_estimate": "lid_kernel.cu"}


def sift1m():
    from repro_torch.configs.mcgi_datasets import DATASETS

    return DATASETS["mcgi-sift1m"]


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
        d = sift1m().d
        if integer:
            table = torch.randint(-8, 9, (n, d), generator=g, device=dev).float()
            ctxs = torch.randint(-8, 9, (q, d), generator=g, device=dev).float()
        else:
            table = torch.randn((n, d), generator=g, device=dev)
            ctxs = torch.randn((q, d), generator=g, device=dev)
        ev = search._exact_eval(table)
    else:
        m, k = M_PQ, 256
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
    return {"name": f"beam_step.{kind}", "route": "cuda",
            "source": CSRC + SOURCES["beam_step"],
            "replaces": REPLACES["beam_step"], "launches": None,
            "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "verdict": "bit-identical on integer data; float within rtol 1e-5"}


def time_calls(fn, hold: bool, reps: int = 20,
               rounds: int = 5) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()``: medians over ``rounds`` of
    the mean of ``reps`` calls back to back, timed as :func:`time_hop`
    does (``hold``: queued behind a sleep kernel, device work alone)."""
    return time_hop(lambda _: fn(), (), hold, reps, rounds)


def record(name, max_err, ms, plain_ms, library_ms, bound, verdict) -> dict:
    base = name.split(".")[0]
    return {"name": name, "route": "cuda", "source": CSRC + SOURCES[base],
            "replaces": REPLACES[base], "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, "verdict": verdict}


def bound_of(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_bulk_kernels(dev, seed: int) -> list[dict]:
    """Phase 2 for ``l2_distance``, ``topk`` and ``lid_estimate`` at the
    shapes the main path gives them: one k-NN chunk of the build (4096
    points against 65536, D=128, k=17; the ground truth's k=10) and the
    LID estimate of 1M points at k=16."""
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops, ref

    cfg = sift1m()
    out = []
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    q = torch.randn((KNN_Q, cfg.d), generator=g, device=dev)
    x = torch.randn((KNN_N, cfg.d), generator=g, device=dev)

    # l2_distance, float32 at the k-NN shape.
    got = ops.bulk_l2(q, x)
    want = ref.l2_distance_ref(q, x)
    sync(dev)
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        raise AssertionError("l2_distance float32 differs from the plain "
                             "version beyond rtol 1e-4 / atol 1e-3")
    err = float((got - want).abs().max())
    del want
    qb, xb = q[:1024].bfloat16(), x[:8192].bfloat16()
    got_b, want_b = ops.bulk_l2(qb, xb), ref.l2_distance_ref(qb, xb)
    sync(dev)
    if not torch.allclose(got_b, want_b, rtol=2e-2, atol=2e-1):
        raise AssertionError("l2_distance bfloat16 differs from the plain "
                             "version beyond rtol 2e-2 / atol 2e-1")
    err_b = float((got_b - want_b).abs().max())
    ms, host = time_calls(lambda: ops.bulk_l2(q, x), hold=True)
    plain_ms, _ = time_calls(lambda: ref.l2_distance_ref(q, x), hold=False)
    lib_ms, _ = time_calls(lambda: distance.squared_l2(q, x), hold=False)
    nq, n, d = KNN_Q, KNN_N, cfg.d
    bound = bound_of((nq + n) * d * 4 + nq * n * 4,
                     2 * nq * n * d + 2 * (nq + n) * d + 3 * nq * n)
    log(f"[phase2] l2_distance {nq}x{n}x{d} float32: within rtol 1e-4 (max "
        f"abs err {err:.3g}); bfloat16 1024x8192x{d} within 2e-2 (max abs "
        f"err {err_b:.3g}); kernel {ms:.4f} ms on the device ({host:.4f} ms "
        f"host), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    out.append(record("l2_distance", err, ms, plain_ms, lib_ms, bound,
                      "float32 within rtol 1e-4 / atol 1e-3; bfloat16 "
                      "within 2e-2 / 2e-1"))

    # topk on that matrix, plus planted ties, a row with fewer than k
    # finite entries, and a few rows cut into segments.
    d = got
    del got, got_b, want_b
    tied = d[:8].clone()
    tied[0] = torch.randint(0, 4, (n,), generator=g, device=dev).float()
    tied[1] = torch.inf
    tied[1, torch.randperm(n, generator=g, device=dev)[:5]] = 3.0
    for k in (17, cfg.k):
        for what, m in (("k-NN chunk", d), ("ties + short row", tied[:2]),
                        ("8 rows in segments", tied)):
            gv, gi = ops.topk(m, k)
            wv, wi = ref.topk_ref(m, k)
            sync(dev)
            if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
                bad = int(((gv != wv) | (gi != wi)).any(1).sum())
                raise AssertionError(f"topk k={k} ({what}): {bad} rows "
                                     f"differ from the plain version")
        log(f"[phase2] topk k={k}: values bitwise and ids equal to the plain "
            f"version ({KNN_Q}x{KNN_N}; planted ties; a row with 5 finite "
            f"entries; 8 rows in segments)")
    k = 17
    ms, host = time_calls(lambda: ops.topk(d, k), hold=True)
    plain_ms, _ = time_calls(lambda: ref.topk_ref(d, k), hold=False)
    lib_ms, _ = time_calls(lambda: torch.topk(d, k, dim=1, largest=False),
                           hold=False)
    bound = bound_of(nq * n * 4 + nq * k * 8, nq * n)
    log(f"[phase2] topk {nq}x{n} k={k}: kernel {ms:.4f} ms on the device "
        f"({host:.4f} ms host), plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    out.append(record("topk", 0.0, ms, plain_ms, lib_ms, bound,
                      "values bitwise, ids equal"))
    del d, tied, q, x

    # lid_estimate on 1M ascending k=16 rows, duplicates included.
    b, kk = sift1m().n, 16
    d2 = torch.sort(torch.rand((b, kk), generator=g, device=dev) + 0.01,
                    dim=1).values
    d2[:1000, :3] = 0.0
    got, want = ops.lid_estimate(d2), ref.lid_ref(d2)
    sync(dev)
    if not torch.allclose(got, want, rtol=1e-4, atol=0.0):
        raise AssertionError("lid_estimate differs from the plain version "
                             "beyond rtol 1e-4")
    err = float((got - want).abs().max())
    ms, host = time_calls(lambda: ops.lid_estimate(d2), hold=True)
    plain_ms, _ = time_calls(lambda: ref.lid_ref(d2), hold=False)
    bound = bound_of(b * kk * 4 + b * 4, 4 * b * kk)
    log(f"[phase2] lid_estimate {b}x{kk}: within rtol 1e-4 (max abs err "
        f"{err:.3g}); kernel {ms:.4f} ms on the device ({host:.4f} ms host), "
        f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    out.append(record("lid_estimate", err, ms, plain_ms, None, bound,
                      "within rtol 1e-4"))
    return out


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
        f"launches={ {k: v for k, v in launches.items() if v} }")
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
        before = ops.launch_counts()["beam_step.pq"]
        t0 = time.perf_counter()
        res = list(eng.search_batches(batches) if pipelined
                   else (eng.search(b) for b in batches))
        qps[w].append(sum(b.shape[0] for b in batches)
                      / (time.perf_counter() - t0))
        launches[w] = ops.launch_counts()["beam_step.pq"] - before
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
    """Build and serve the deployment; returns the launch counts of this
    run (counts set to 0 at its start) and what the calibration path needs."""
    from repro_torch import serving
    from repro_torch.core import build, distance
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.index import build_tiered_index
    from repro_torch.kernels import ops

    cfg = sift1m()
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
    bcfg = build.BuildConfig(degree=cfg.degree, beam_width=cfg.l_build,
                             alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
                             batch=build_batch, seed=seed)
    timings: dict = {}
    t0 = time.perf_counter()
    graph = build.build_mcgi(x, bcfg, progress=lambda m: log(f"[build] {m}"),
                             device=dev, timings=timings)
    t_build = time.perf_counter() - t0
    log(f"[build] MCGI build {t_build:.1f}s (R={bcfg.degree} "
        f"L={bcfg.beam_width} T={bcfg.iters} batch={bcfg.batch}): "
        + " ".join(f"{k}={v:.1f}s" for k, v in timings.items())
        + f"; mean out-degree {float(graph.out_degrees().float().mean()):.2f}"
        f"; build launches {ops.launch_counts()}")
    log(f"[build] lid_knn {timings['lid_knn']:.3f}s (exact k-NN of 1 point "
        f"in {x.shape[0]} against all through l2_distance + topk, then "
        f"lid_estimate)")
    t0 = time.perf_counter()
    index = build_tiered_index(x, graph, m_pq=M_PQ, device=dev)
    sync(dev)
    log(f"[build] PQ tier m={M_PQ} in "
        f"{time.perf_counter() - t0:.1f}s (fast tier "
        f"{index.fast_tier_bytes() / 1e6:.1f} MB, slow tier "
        f"{index.slow_tier_bytes() / 1e6:.1f} MB)")
    t0 = time.perf_counter()
    before = ops.launch_counts()
    _, gt_i = distance.brute_force_topk(queries, x, k=cfg.k)
    gt = gt_i.cpu().numpy()
    after = ops.launch_counts()
    log(f"[main] ground truth in {time.perf_counter() - t0:.1f}s "
        f"(l2_distance {after['l2_distance'] - before['l2_distance']}, "
        f"topk {after['topk'] - before['topk']} launches)")

    qn = queries.cpu().numpy()
    batches = [qn[s:s + batch] for s in range(0, qn.shape[0], batch)]
    gts = [gt[s:s + batch] for s in range(0, qn.shape[0], batch)]
    budget = cfg.beam_budget()
    tiered = serving.TieredBackend(index, device=dev)
    exact = serving.ExactBackend(x, graph.adj, graph.entry, device=dev)
    eng_t = serving.SearchEngine(tiered, budget, k=cfg.k)
    eng_e = serving.SearchEngine(exact, budget, k=cfg.k)
    eng_f = serving.SearchEngine(tiered, None, k=cfg.k,
                                 beam_width=cfg.l_search,
                                 max_hops=cfg.max_hops)
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
    log(f"[main] kernel launches on the main path: {counts}")
    if runs["tiered_adaptive_pipelined"]["launches"]["beam_step.pq"] == 0:
        raise AssertionError("tiered serving never launched beam_step[pq]")
    if runs["exact_adaptive"]["launches"]["beam_step.exact"] == 0:
        raise AssertionError("exact serving never launched beam_step[exact]")
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")
    rec = runs["tiered_adaptive_pipelined"]["recall"]
    if rec < RECALL_FLOOR:
        raise AssertionError(f"tiered adaptive recall@10 {rec:.4f} < "
                             f"{RECALL_FLOOR}")
    compare_serving(eng_t, serving.SearchEngine(tiered, budget, k=cfg.k,
                                                num_buckets=4), batches)
    return counts, dict(n=n, qn=qn, gt=gt, batches=batches, gts=gts,
                        tiered=tiered, exact=exact)


# --------------------------------------------------------------- phase 3b

def calibration_path(world) -> dict:
    """Fit the budget law of each adaptive engine to its recall target with
    ``SearchEngine.recalibrate(joint=True)``, then serve the stream with
    the fitted law.  Returns the launch counts of this run."""
    from repro_torch import serving
    from repro_torch.kernels import ops

    cfg = sift1m()
    n, qn, gt = world["n"], world["qn"], world["gt"]
    ops.reset_launch_counts()
    served = {}
    for name, backend, target in (("exact", world["exact"],
                                   cfg.recall_target),
                                  ("tiered", world["tiered"],
                                   TIERED_TARGET)):
        eng = serving.SearchEngine(backend, cfg.beam_budget(), k=cfg.k)
        t0 = time.perf_counter()
        res = eng.recalibrate(qn, gt, recall_target=target, joint=True,
                              sample=CALIB_SAMPLE)
        secs = time.perf_counter() - t0
        fit = eng.budget_cfg
        log(f"[calibrate] {name}: target {target:.2f} "
            f"{'achieved' if res.achieved else 'MISSED'}: lam={res.lam:.4f} "
            f"l_min={fit.l_min} hop_factor={fit.hop_factor} "
            f"recall={res.recall:.4f} on {CALIB_SAMPLE} held-out queries, "
            f"{len(res.history)} evaluations, {secs:.2f}s; joint history "
            f"{[(lm, round(lam, 4), hf, round(r, 4), ok) for lm, lam, hf, r, ok in res.joint_history]}")
        if name == "exact" and not res.achieved:
            raise AssertionError(f"the exact fit missed its target {target}")
        eng.search(qn[:64])                                # warm-up
        served[name] = serve_run(f"{name} adaptive, fitted law", eng,
                                 world["batches"], world["gts"], n,
                                 name == "tiered")
        served[name]["target"] = target
    counts = ops.launch_counts()
    log(f"[calibrate] kernel launches on the calibration path: {counts}")
    for kind in ("exact", "pq"):
        if counts[f"beam_step.{kind}"] == 0:
            raise AssertionError(f"beam_step.{kind} was never launched on "
                                 f"the calibration path")
    floor = cfg.recall_target - SERVED_RECALL_SLACK
    if served["exact"]["recall"] < floor:
        raise AssertionError(f"exact adaptive with the fitted law served "
                             f"recall@10 {served['exact']['recall']:.4f} < "
                             f"{floor:.2f}")
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
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    card = gpu_name_power()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(dev)}")
    t0 = time.perf_counter()
    _build.build_all(ops.LIBRARIES)
    for lib in ops.LIBRARIES:
        lib.fn()
    log(f"[build] {len(ops.LIBRARIES)} kernel libraries built and loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    for lib in ops.LIBRARIES:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas {lib.name}: {line.strip()}")

    cfg = sift1m()
    kernels = [check_kernel(kind, dev, KERNEL_N, KERNEL_Q, cfg.l_search,
                            cfg.degree, 12, args.seed + 7 * i)
               for i, kind in enumerate(("exact", "pq"))]
    torch.cuda.empty_cache()
    kernels += check_bulk_kernels(dev, args.seed)
    torch.cuda.empty_cache()

    counts, world = main_path(dev, args.n, N_QUERIES, SERVE_BATCH,
                              BUILD_BATCH, args.seed)
    calib_counts = calibration_path(world)
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
        rec["calibration_launches"] = calib_counts[rec["name"]]
    log("kernels: " + json.dumps({r["name"]: {
        "launches": r["launches"],
        "calibration_launches": r["calibration_launches"],
        "phase2": r["verdict"]} for r in kernels}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
