#!/usr/bin/env python3
"""Drive the PyTorch port of MCGI (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases, each printed on its own lines; any failure exits non-zero:

1. device and build — the card's name and power limit (nvidia-smi), then the
   six kernel libraries (``beam_step``, ``l2_distance``, ``topk``,
   ``lid_kernel``, ``pq_scan``, ``decode_attention``) compiled from
   ``src/repro_torch/csrc`` with nvcc, one process each, all started
   together;
2. kernel vs plain version, at the main paths' own shapes —
   ``beam_step`` in both kinds at serving shape (Q=1024, L=128, R=64, N=1M;
   D=128 exact, M=16 x K=256 PQ) for 12 hops of one launch each:
   bit-identical to ``beam_step_ref`` on integer-valued tables and
   contexts, and on float data beam_d within 1e-5 relative with ids and
   visited words equal in every lane without a near-tie; the resident walk
   (``beam_walk``) as one launch of 12 hops and one launch to convergence
   (hop limits up to 200), each bit-identical to ``beam_step_ref`` hop by
   hop on integer data, with the lanes it leaves movable counted; its
   device time per hop beside the one-hop launch's; ``l2_distance`` at the k-NN shape (4096 x 65536
   x 128) float32 within rtol 1e-4 / atol 1e-3, on integer operands
   (0-255) at that shape bit-identical, on SIFT-scale near duplicates
   (1024 x 8192) within rtol 1e-4 / atol 1e-3 of float64 and no more than
   4x the plain version's error, bfloat16 at 1024 x 8192 x 128 within
   2e-2 / 2e-1; its bound is that of its three TF32 products on the tensor
   cores, printed beside the float32 SIMT bound; ``topk`` on that float32
   output at k = 17 and 10 (and on a row with planted ties, a row with
   fewer than k finite entries and 8 rows cut into segments), at k = 100
   and 101 (the 128-key warp-select), at k = 2048 (the radix select) on 8
   rows with ties, +inf and NaN, and at [adc]'s chunk shape (256 x 1M,
   k = 10 and 100), each timed: values bitwise and ids exactly equal;
   ``lid_estimate`` at 1M x 16, 1M x 1 and 100k x 100 within rtol 1e-4
   (timed at 1M x 16); ``decode_attention`` at
   qwen2-7b's heads (28 query, 4 KV, d=128, bfloat16 cache) at
   [lm-serve]'s shape (B=8, S=160), at the ``decode_32k`` shape with batch
   cut to 16 and at the ``long_500k`` shape, ragged kv_len including 0, 1
   and S, within 3e-4; ``pq_scan`` at
   (256, 16, 256) LUTs x (1M, 16) codes, bit for bit on integer-valued LUTs
   and within 1e-5 on float LUTs, timed on random codes and on all-zero
   codes (the design's conflict-free floor on the card), beside its bytes
   bound and shared memory's own floor.  Each kernel's device time per launch
   (launches queued back to back behind a sleep kernel, so host work is not
   timed), the plain version's time, the library call's time where one
   PyTorch call computes the same function, and the bound;
3. the main path at the ``mcgi-sift1m`` deployment (the paper's Table 2,
   ``repro_torch/configs/mcgi_datasets.py``: N=1M, D=128, R=64,
   L_build=100, alpha in [1, 1.5], l_search=128, k=10, max_hops=192,
   lam=0.25, l_min=8, probe_hops=8, hop_factor=4; PQ m=16) on synthetic
   SIFT1M-shaped data drawn from --seed on the card: MCGI build (the LID
   k-NN through ``l2_distance`` + ``topk``, the estimate through
   ``lid_estimate``, then the alpha-mapped prune), PQ tier, ground truth,
   then serving through the engine — tiered adaptive pipelined (the ``pq``
   kind), exact adaptive (the ``exact`` kind) and one fixed-beam batch at
   beam 128; fails if any of the five MCGI kernels was never launched,
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
3c. [adc] bulk ADC retrieval — ``adc_topk(k=10)`` of the 10,000 queries
   against phase 3's 1M x 16 PQ codes, in chunks of 256 queries (one
   ``pq_scan`` and one ``topk`` each); recall@10 against the exact ground
   truth, printed with no gate (exhaustive ADC without a rerank), and the
   time of one ``retrieval_cand``-shaped call (1 query x 1M candidates);
   fails unless both kernels launched once per chunk, and unless the
   first chunk's results and the 1-query call's equal ``pq_scan_ref`` +
   ``topk_ref`` on the same LUTs, values and ids; then, after the counts
   are read, ``adc_topk(k=100)`` over the first chunk, held to the plain
   versions and to the k=10 run, and timed;
3d. [disk] the disk-resident slow tier at the same 1M index and stream:
   ``open_or_build_slow_tier`` writes the node-order block store (1 KiB
   records) to a temporary directory (removed when the phase ends) and
   serves the stream through ``TieredBackend(slow_tier=...)`` pipelined
   (the engine's prefetch stage) and per batch; the same store with a
   65,536-node hot tier for two pipelined passes (promotions drained
   between them; the second open must reuse the store, mtime unchanged);
   a store packed by ``block_layout(nodes_per_block=4)`` (four records a
   4 KiB page); and ``save_index(version=2)`` + ``load_index`` on the card
   (every array equal) served through ``load_slow_tier``.  Every run's ids
   and d2 must equal the in-memory tiered run's bit for bit; each prints
   QPS, batch p50 / p99, recall@10, hit rate, blocks read, I/O blocks per
   query, measured read us and fetch p50 / p99 (reads from the OS page
   cache, not an SSD); fails unless ``beam_step`` [pq] launched there;
4. the LM paths, with the MCGI world freed — qwen2-7b at full width
   (``repro_torch/configs/qwen2_7b.py``: 28 layers, d_model 3584, 28 query
   and 4 KV heads, d_ff 18944, vocab 152064, QKV bias), weights drawn from
   --seed in bfloat16 on the card:
   [lm-serve] 8 prompts of 128 tokens teacher-forced through
   ``decode_step`` into a cache of 160, then greedy generation to 32
   tokens a row; ``prefill(prompts)``'s last logits against the decode
   path's at position 127 within a relative L2 error of 5e-2;
   ``decode_attention``'s outputs at layer 0 of steps 0, 127 and 158
   within 3e-4 of its plain version on the same tensors; a second run
   must generate identical tokens; tokens/s and the step's p50 / p99;
   [lm-decode_32k] (B=16 of the cell's 128, S=32768) and [lm-long_500k]
   (B=1, S=524288): the cache filled with random bfloat16 values from the
   seed, kv_len = S - 1, 16 steps: the step's p50 / p99 ms and tokens/s
   against its bound, ``decode_attention``'s device ms per launch and its
   share of the step; fails unless ``decode_attention`` launched 28 times a
   step on each path;
5. the kernels line (launches of each kernel on every path), then one JSON
   object per the port's contract, and the device line last.

Needs one CUDA card; there is no CPU path.

    python3 chip_smoke.py --trace-first-batch

also records the first batch of the tiered adaptive pipelined run under
``torch.profiler`` (host and device activity from the call to the first
result) and writes ``chiprun_out/first_batch_trace.txt`` (operators by
self host time and by device time, and the device's busy share of the
batch) with the Chrome trace beside it; that run's timings carry the
profiler's overhead.
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
BF16_TC_OPS_PER_S = 989e12                # dense, tensor cores
TF32_TC_OPS_PER_S = 495e12                # dense, tensor cores
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
WALK_HOPS = 12                           # phase 2: hops of the capped walk
WALK_HOP_LIMIT = 200                     # phase 2: the walk to convergence
CSRC = "src/repro_torch/csrc/"
REPLACES = {"beam_step": "src/repro/kernels/beam_step.py:180",
            "l2_distance": "src/repro/kernels/l2_distance.py:38",
            "topk": "src/repro/kernels/topk.py:45",
            "lid_estimate": "src/repro/kernels/lid_kernel.py:36",
            "pq_scan": "src/repro/kernels/pq_scan.py:52",
            "decode_attention": "src/repro/kernels/decode_attention.py:70"}
SOURCES = {"beam_step": "beam_step.cu", "l2_distance": "l2_distance.cu",
           "topk": "topk.cu", "lid_estimate": "lid_kernel.cu",
           "pq_scan": "pq_scan.cu", "decode_attention": "decode_attention.cu"}
# The kernels of the MCGI main path (phase 3); phase 3c adds pq_scan, the
# LM paths decode_attention.
MCGI_KERNELS = ("beam_step.exact", "beam_step.pq", "l2_distance", "topk",
                "lid_estimate")
ATTN_TOL = 3e-4                          # the reference's kernel tolerance
PQ_Q, PQ_M, PQ_K = 256, 16, 256          # one adc_topk chunk at N = 1M
ADC_K = 10
ADC_K_WIDE = 100                         # recall@100's k
TOPK_K_RADIX = 2048                      # a k past the warp-select's 256
# Instructions of IEEE sqrtf + division + logf an element, counted as
# float32 operations for lid_estimate's bound.
LID_OPS_PER_ELEMENT = 40
LM_BATCH, LM_PROMPT, LM_GEN = 8, 128, 32
# [lm-serve] steps whose layer-0 decode_attention is held to the plain
# version: the first, the last teacher-forced and the last generated.
LM_CHECK_STEPS = (0, LM_PROMPT - 1, LM_PROMPT + LM_GEN - 2)
# Prefill vs decode logits in bfloat16: the CPU tests see 1.2e-2 relative
# L2 between the two frameworks over 2 layers; 28 layers get the most the
# check allows.
PREFILL_REL_L2 = 5e-2
# (cell, batch, S): decode_32k's batch is cut from 128 (224 GiB of cache).
LM_CELLS = (("decode_32k", 16, 32768), ("long_500k", 1, 524288))
LM_CELL_STEPS = 16


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


def walk_bound(kind, states, ctxs, adj, table, budgets, hop_limits):
    """Least time the card could take for the walk through ``states``
    (``states[0]`` the state at launch, ``states[h]`` after h hops; one
    hop: two states): the larger of the bytes it must move over the HBM
    rate and the operations it must do over the float32 rate.  Bytes: every
    lane's beam and counters read once, the beams of lanes that moved
    written once, each moving lane's context (exact query) read once, and
    per hop the adjacency row and visited words of each active lane and the
    rows (or codes and LUT entries) of each valid neighbour.  Operations:
    the distances of the valid neighbours and the sorted-beam merge,
    L*R + R*(R + log2 L) compares per active lane-hop.  Data-dependent:
    active lanes and valid neighbours as this run's data has them."""
    import math

    from repro_torch.kernels.ref import lane_active

    q, width = states[0][0].shape
    r = adj.shape[1]
    row = (table.shape[1] * 4 if kind == "exact"
           else table.shape[1] * (1 + 4))        # codes + LUT entries
    ctx = ctxs.shape[1] * 4 if kind == "exact" else 0
    beam = width * (4 + 4 + 1)
    lane_io = 4 * 4                              # budget, limit, hops, evals
    moved = int((states[-1][4] != states[0][4]).sum())
    nbytes = q * (beam + lane_io) + moved * (beam + 8 + ctx)
    ops = 0
    merge = width * r + r * (r + math.log2(width))
    for s0, s1 in zip(states[:-1], states[1:]):
        n_act = int(lane_active(s0[0], s0[2], s0[4], budgets,
                                hop_limits).sum())
        n_valid = int((s1[5] - s0[5]).sum())
        nbytes += n_act * (r * 4 + r * 4) + n_valid * (row + 4)
        ops += n_valid * (table.shape[1] * 3 if kind == "exact"
                          else table.shape[1]) + n_act * merge
    return bound_of(nbytes, ops)


def check_kernel(kind, dev, n, q, width, r, hops: int, seed: int):
    """Phase 2 for one kind: bit identity on integer data (one hop per
    launch, and the resident walk), tolerance on float data, timings and
    bounds.  Returns the kernel's record: its ``ms``, ``plain_ms`` and
    ``bound_ms`` are per hop of the walk, as the main path launches it."""
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

    # The resident walk, bit for bit on integer data: one launch capped at
    # WALK_HOPS hops (hop limits that never bind), and one launch to
    # convergence (hop limits up to WALK_HOP_LIMIT, so lanes freeze both at
    # their limit and at a closed frontier).
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    far = torch.full_like(hop_limits, 1 << 20)
    deep = torch.randint(2, WALK_HOP_LIMIT + 1, (q,), generator=g,
                         device=dev, dtype=torch.int32)
    for cap, limits, what in ((WALK_HOPS, far, f"{WALK_HOPS} hops"),
                              (ops.MAX_HOPS, deep, "to convergence")):
        want, left = ref.beam_walk_ref(st0, ctxs, adj, table, budgets,
                                       limits, kind=kind, max_hops=cap)
        count = torch.zeros((1,), dtype=torch.int32, device=dev)
        got = ops.beam_walk(clone(st0), ctxs, adj, table, budgets, limits,
                            kind=kind, max_hops=cap, active_count=count)
        sync(dev)
        for name, a, b in zip(("ids", "d", "exp", "visited", "hops",
                               "evals"), got, want):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(a.shape[0], -1).any(1).sum())
                raise AssertionError(f"beam_walk[{kind}] {what}: {name} "
                                     f"differs from beam_step_ref hop by "
                                     f"hop in {bad} lanes (integer data)")
        if int(count) != int(left.sum()):
            raise AssertionError(f"beam_walk[{kind}] {what}: counted "
                                 f"{int(count)} movable lanes, not "
                                 f"{int(left.sum())}")
        log(f"[phase2] beam_walk[{kind}] one launch {what}: bit-identical "
            f"to beam_step_ref hop by hop (integer data; hops per lane "
            f"{int(want[4].min())}-{int(want[4].max())}, lanes left movable "
            f"{int(count)})")
        del want, got

    # Timing from a mid-walk state, every lane active: one hop per launch,
    # and one launch of WALK_HOPS hops (per hop).
    full = torch.full_like(budgets, width)
    mid = st0
    for _ in range(4):
        mid = ref.beam_step_ref(mid, ctxs, adj, table, full, far, kind=kind)
    chain = [mid]
    for _ in range(WALK_HOPS):
        chain.append(ref.beam_step_ref(chain[-1], ctxs, adj, table, full,
                                       far, kind=kind))
    if int((chain[-1][4] - mid[4]).min()) != WALK_HOPS:
        raise AssertionError("a lane froze inside the timed walk")

    def hop(s):
        return ops.beam_step(s, ctxs, adj, table, full, far, kind=kind)

    def walk(s):
        return ops.beam_walk(s, ctxs, adj, table, full, far, kind=kind,
                             max_hops=WALK_HOPS)

    def plain(s):
        return ref.beam_step_ref(s, ctxs, adj, table, full, far, kind=kind)

    for _ in range(3):                                   # warm-up
        hop(clone(mid))
        walk(clone(mid))
        plain(mid)
    ms, host_ms = time_hop(hop, mid, hold=True)
    walk_ms, walk_host = time_hop(walk, mid, hold=True)
    plain_ms, _ = time_hop(plain, mid, hold=False)
    bound = walk_bound(kind, chain[:2], ctxs, adj, table, full, far)
    wbound = walk_bound(kind, chain, ctxs, adj, table, full, far)
    per_hop, wbound_hop = walk_ms / WALK_HOPS, wbound[0] / WALK_HOPS
    log(f"[phase2] beam_step[{kind}] one hop, {q} lanes: kernel {ms:.4f} ms "
        f"on the device ({host_ms:.4f} ms of wrapper host time per launch), "
        f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    log(f"[phase2] beam_walk[{kind}] {WALK_HOPS} hops in one launch, {q} "
        f"lanes: {walk_ms:.4f} ms on the device = {per_hop:.4f} ms per hop "
        f"(one-hop launch {ms:.4f}; {walk_host:.4f} ms of host time per "
        f"launch), bound {wbound[0]:.4f} ms = {wbound_hop:.4f} per hop "
        f"({wbound[1]})")
    del st0, st_k, st_p, st, adj_f, table_f, chain
    return {"name": f"beam_step.{kind}", "route": "cuda",
            "source": CSRC + SOURCES["beam_step"],
            "replaces": REPLACES["beam_step"], "launches": None,
            "max_abs_err": max_err,
            "ms": per_hop, "plain_ms": plain_ms, "bound_ms": wbound_hop,
            "bound_by": wbound[1], "library_ms": None,
            "one_hop_launch": {"ms": ms, "host_ms": host_ms,
                               "bound_ms": bound[0]},
            "walk": {"hops": WALK_HOPS, "ms": walk_ms, "host_ms": walk_host},
            "verdict": "bit-identical on integer data (hop by hop, a "
                       f"{WALK_HOPS}-hop launch, a launch to convergence); "
                       "float within rtol 1e-5"}


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


def bound_of(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sift_near_duplicates(dev, g) -> tuple[float, float]:
    """``l2_distance`` at SIFT scale (coordinates in [0, 255], |q|^2 near
    2.8e6) on 1024 queries against a near duplicate of each (coordinates
    moved by up to 40: d2 about 2% of |q|^2) and 7168 far points: within
    rtol 1e-4 / atol 1e-3 of float64, and no more than 4x the plain float32
    version's error.  Returns both max abs errors."""
    import torch

    from repro_torch.kernels import ops, ref

    q = torch.rand((1024, 128), generator=g, device=dev) * 255
    near = q + (torch.rand(q.shape, generator=g, device=dev) - 0.5) * 80
    far = torch.rand((7168, 128), generator=g, device=dev) * 255
    x = torch.cat([near.clamp(0, 255), far])
    q64, x64 = q.double(), x.double()
    truth = ((q64 * q64).sum(1, keepdim=True) - 2 * q64 @ x64.T
             + (x64 * x64).sum(1)).clamp_min(0)
    got = ops.bulk_l2(q, x).double()
    plain = ref.l2_distance_ref(q, x).double()
    sync(dev)
    if not torch.allclose(got, truth, rtol=1e-4, atol=1e-3):
        raise AssertionError("l2_distance on SIFT-scale near duplicates "
                             "differs from float64 beyond rtol 1e-4")
    err = float((got - truth).abs().max())
    err_plain = float((plain - truth).abs().max())
    if err > 4 * err_plain:
        raise AssertionError(f"l2_distance error {err:.3g} on SIFT-scale "
                             f"near duplicates exceeds 4x the plain "
                             f"version's {err_plain:.3g}")
    return err, err_plain


def topk_timed(dist, k: int, what: str) -> dict:
    """``topk`` of ``dist`` at ``k``: held to the plain version (values
    bitwise, ids equal), then timed beside the plain version, the library
    call (``torch.topk``) and the bound; one ``[phase2] topk`` line."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import topk as topk_kernel

    nq, n = dist.shape
    gv, gi = ops.topk(dist, k)
    wv, wi = ref.topk_ref(dist, k)
    sync(dist.device)
    if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
        bad = int(((gv != wv) | (gi != wi)).any(1).sum())
        raise AssertionError(f"topk at {nq}x{n} k={k} ({what}): {bad} rows "
                             f"differ from the plain version")
    del gv, gi, wv, wi
    slots = topk_kernel.warp_slots(k)
    if slots == 0:
        how = "radix select, a block a row"
    else:
        segs = -(-n // topk_kernel.segment_length(nq, n, slots))
        how = f"warp-select, {segs} segment{'s' if segs > 1 else ''} a row"
    ms, host = time_calls(lambda: ops.topk(dist, k), hold=True)
    plain_ms, _ = time_calls(lambda: ref.topk_ref(dist, k), hold=False)
    lib_ms, _ = time_calls(lambda: torch.topk(dist, k, dim=1, largest=False),
                           hold=False)
    bound = bound_of(nq * n * 4 + nq * k * 8, nq * n)
    log(f"[phase2] topk {nq}x{n} k={k} ({what}; {how}): values bitwise and "
        f"ids equal to the plain version; kernel {ms:.4f} ms on the device "
        f"({host:.4f} ms host), plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return {"shape": [nq, n, k], "what": what, "route": how, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def topk_adc_shape(dev, g, d: int) -> list[dict]:
    """``topk`` at [adc]'s chunk shape (256 queries x 1M, rows cut into
    segments), k = 10 and 100: held to the plain version, then timed."""
    import torch

    from repro_torch.kernels import ops

    dist = ops.bulk_l2(torch.randn((PQ_Q, d), generator=g, device=dev),
                       torch.randn((KERNEL_N, d), generator=g, device=dev))
    return [topk_timed(dist, k, "[adc]'s chunk") for k in (ADC_K, ADC_K_WIDE)]


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
    # Integer operands in SIFT's range (0-255) at the k-NN shape: exact.
    qi = torch.randint(0, 256, q.shape, generator=g, device=dev).float()
    xi = torch.randint(0, 256, x.shape, generator=g, device=dev).float()
    xi[:KNN_Q // 2] = qi[:KNN_Q // 2]
    if not torch.equal(ops.bulk_l2(qi, xi), ref.l2_distance_ref(qi, xi)):
        raise AssertionError("l2_distance on integer operands differs from "
                             "the plain version")
    del qi, xi
    err_sift, err_sift_plain = sift_near_duplicates(dev, g)
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
    nbytes = (nq + n) * d * 4 + nq * n * 4
    # The cross term as the kernel takes it: three TF32 products (3xTF32)
    # on the tensor cores; beside it, the bound of any float32 SIMT kernel.
    bound = bound_of(nbytes, 3 * 2 * nq * n * d, TF32_TC_OPS_PER_S)
    simt = bound_of(nbytes, 2 * nq * n * d + 2 * (nq + n) * d + 3 * nq * n)
    log(f"[phase2] l2_distance {nq}x{n}x{d} float32: within rtol 1e-4 (max "
        f"abs err {err:.3g}); integer operands (0-255) bit-identical; SIFT-"
        f"scale near duplicates within rtol 1e-4 of float64 (max abs err "
        f"{err_sift:.3g}, plain float32 {err_sift_plain:.3g}); bfloat16 "
        f"1024x8192x{d} within 2e-2 (max abs err {err_b:.3g}); kernel "
        f"{ms:.4f} ms on the device ({host:.4f} ms host), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]}, 3xTF32 on the tensor cores; float32 SIMT bound "
        f"{simt[0]:.4f} ms)")
    rec = record("l2_distance", err, ms, plain_ms, lib_ms, bound,
                 "float32 within rtol 1e-4 / atol 1e-3; integer operands "
                 "bit-identical; SIFT-scale near duplicates within rtol "
                 "1e-4 of float64; bfloat16 within 2e-2 / 2e-1")
    rec["bound_fp32_simt_ms"] = simt[0]
    out.append(rec)

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
    t = topk_timed(d, 17, "k-NN chunk")
    rec = record("topk", 0.0, t["ms"], t["plain_ms"], t["library_ms"],
                 (t["bound_ms"], t["bound_by"]),
                 "values bitwise, ids equal (k = 10, 17, 100, 101, "
                 f"{TOPK_K_RADIX})")
    # Past the 64-key list: recall@100's k (and 101, as a k-NN asks for
    # k + 1) at the k-NN shape, and the radix select past 256 on a few
    # rows: planted ties, a row of 5 finite entries padded by +inf, NaN.
    wide = [topk_timed(d, kk, "k-NN chunk") for kk in (ADC_K_WIDE,
                                                       ADC_K_WIDE + 1)]
    few = torch.cat([d[:5], tied[:2], d[5:6]])
    nan = torch.rand((n,), generator=g, device=dev) < 0.3
    nan[:TOPK_K_RADIX] = False
    few[7, nan] = torch.nan
    wide.append(topk_timed(few, TOPK_K_RADIX, "8 rows: ties, +inf, NaN"))
    del d, tied, q, x, few
    rec["adc_shape"] = topk_adc_shape(dev, g, cfg.d)
    rec["large_k"] = wide
    out.append(rec)

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
    # k = 1 (every estimate the -1/4096 cap) and k = 100 (a row in chunks
    # of 32), zero distances included.
    errs = {}
    for bk, kk2 in ((b, 1), (100_000, 100)):
        d2k = torch.sort(torch.rand((bk, kk2), generator=g, device=dev)
                         + 0.01, dim=1).values
        d2k[:1000, :max(1, kk2 // 4)] = 0.0
        d2k[1000] = 0.0
        gk, wk = ops.lid_estimate(d2k), ref.lid_ref(d2k)
        sync(dev)
        if not torch.allclose(gk, wk, rtol=1e-4, atol=0.0):
            raise AssertionError(f"lid_estimate {bk}x{kk2} differs from the "
                                 f"plain version beyond rtol 1e-4")
        errs[kk2] = float((gk - wk).abs().max())
        del d2k, gk, wk
    ms, host = time_calls(lambda: ops.lid_estimate(d2), hold=True)
    plain_ms, _ = time_calls(lambda: ref.lid_ref(d2), hold=False)
    # Bytes, or about 40 float32 operations an element (the IEEE sqrtf,
    # division and logf) at the float32 peak, whichever is longer.
    bound = bound_of(b * kk * 4 + b * 4, LID_OPS_PER_ELEMENT * b * kk)
    log(f"[phase2] lid_estimate {b}x{kk}: within rtol 1e-4 (max abs err "
        f"{err:.3g}); {b}x1 and 100000x100 within rtol 1e-4 (max abs err "
        f"{errs[1]:.3g}, {errs[100]:.3g}); kernel {ms:.4f} ms on the device "
        f"({host:.4f} ms host), plain {plain_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    out.append(record("lid_estimate", max(err, *errs.values()), ms, plain_ms,
                      None, bound, "within rtol 1e-4 at k = 1, 16, 100"))
    return out


def qwen2():
    from repro_torch.configs import qwen2_7b

    return qwen2_7b.CONFIG


def attention_bound(lens, s: int, hq: int, hkv: int, d: int,
                    kv_bytes: int) -> tuple[float, str]:
    """Least time for one decode_attention launch: K and V up to each row's
    kv_len (clamped to S) read once, q (float32) read and the float32
    output written once; 4 flops per (valid position, query head, dim) at
    the bf16 tensor-core rate, where the kernel runs them."""
    valid = int(lens.clamp(0, s).sum())
    b = lens.shape[0]
    nbytes = 2 * valid * hkv * d * kv_bytes + b * hq * d * (4 + 4)
    return bound_of(nbytes, 4 * valid * hq * d, BF16_TC_OPS_PER_S)


def sdpa_time(q, k, v, lens):
    """Device time of F.scaled_dot_product_attention (GQA, boolean mask) on
    (B, H, S, d) views of the same tensors, or None where the installed
    PyTorch refuses the call."""
    import torch
    import torch.nn.functional as F

    s = k.shape[1]
    mask = (torch.arange(s, device=k.device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              enable_gqa=True)
    try:
        call()
        sync(k.device)
    except RuntimeError as e:         # the yardstick only, never the port
        log(f"[phase2] decode_attention library call refused: {e}")
        return None
    return time_calls(call, hold=False)[0]


def attention_check(where: str, q, k, v, lens, got=None) -> float:
    """Hold decode_attention's output (launched here unless ``got`` is
    given) to its plain version on the same tensors within ATTN_TOL, and
    to zeros at kv_len = 0; returns the max abs error."""
    import torch

    from repro_torch.kernels import ops, ref

    if got is None:
        got = ops.decode_attention(q, k, v, lens)
    want = ref.decode_attention_gqa_ref(q, k, v, lens)
    sync(q.device)
    if not torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL):
        raise AssertionError(
            f"decode_attention ({where}): differs from the plain version "
            f"beyond {ATTN_TOL} (kv_len {lens.tolist()[:4]})")
    if bool((lens == 0).any()) and not bool((got[lens == 0] == 0).all()):
        raise AssertionError("decode_attention: kv_len = 0 must give zeros")
    return float((got - want).abs().max())


def check_decode_attention(dev, seed: int) -> dict:
    """decode_attention at qwen2-7b's heads against its plain version at
    the lm-serve (B=8, S=160), decode_32k (B=16) and long_500k shapes;
    timed at kv_len = S - 1, the LM cells' length."""
    import torch

    from repro_torch.kernels import ops, ref

    cfg = qwen2()
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = torch.Generator(device=dev).manual_seed(seed + 303)
    err, timings = 0.0, {}
    # [lm-serve]'s shape is checked here too (ragged), and timed on no
    # path: its cache is small.
    for cell, b, s in (("lm-serve", LM_BATCH, LM_PROMPT + LM_GEN),
                       ) + LM_CELLS:
        q = torch.randn((b, hq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
        ragged = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                               dtype=torch.int32)
        if b > 2:
            ragged[:3] = torch.tensor([0, 1, s], device=dev)
        checks = [ragged] if b > 1 else [ragged, torch.tensor(
            [s], device=dev, dtype=torch.int32), torch.tensor(
            [1], device=dev, dtype=torch.int32)]
        for lens in checks:
            err = max(err, attention_check(f"phase 2 {cell}", q, k, v, lens))
        if cell == "lm-serve":
            log(f"[phase2] decode_attention {cell} B={b} S={s} Hq={hq} "
                f"Hkv={hkv} d={d} bf16: within {ATTN_TOL} on ragged kv_len "
                f"{ragged.tolist()}")
            continue
        lens = torch.full((b,), s - 1, device=dev, dtype=torch.int32)
        ms, host = time_calls(lambda: ops.decode_attention(q, k, v, lens),
                              hold=True)
        plain_ms, _ = time_calls(
            lambda: ref.decode_attention_gqa_ref(q, k, v, lens), hold=False)
        lib_ms = sdpa_time(q, k, v, lens)
        bound = attention_bound(lens, s, hq, hkv, d, 2)
        timings[cell] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound[0], bound_by=bound[1])
        log(f"[phase2] decode_attention {cell} B={b} S={s} Hq={hq} Hkv={hkv} "
            f"d={d} bf16: within {ATTN_TOL} on ragged kv_len; at kv_len = "
            f"S-1 kernel {ms:.4f} ms on the device ({host:.4f} ms host), "
            f"plain {plain_ms:.4f} ms, library "
            f"{'refused' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound[0]:.4f} ms ({bound[1]})")
        del q, k, v
        torch.cuda.empty_cache()
    t = timings["decode_32k"]
    rec = record("decode_attention", err, t["ms"], t["plain_ms"],
                 t["library_ms"], (t["bound_ms"], t["bound_by"]),
                 f"bfloat16 cache within {ATTN_TOL} at lm-serve's (8, 160) "
                 f"ragged, decode_32k (B=16) and long_500k; kv_len = 0 "
                 f"gives zeros")
    rec["long_500k"] = timings["long_500k"]
    return rec


def check_pq_scan(dev, seed: int) -> dict:
    """pq_scan at one adc_topk chunk of phase 3c: (256, 16, 256) LUTs x
    (1M, 16) codes; bit for bit on integer LUTs, 1e-5 on float LUTs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    n = sift1m().n
    g = torch.Generator(device=dev).manual_seed(seed + 404)
    codes = torch.randint(0, PQ_K, (n, PQ_M), generator=g, device=dev,
                          dtype=torch.uint8)
    luts_i = torch.randint(0, 64, (PQ_Q, PQ_M, PQ_K), generator=g,
                           device=dev).float()
    luts = torch.rand((PQ_Q, PQ_M, PQ_K), generator=g, device=dev) * 64.0
    got, want = ops.pq_bulk_scan(luts_i, codes), ref.pq_scan_ref(luts_i, codes)
    sync(dev)
    if not torch.equal(got, want):
        raise AssertionError("pq_scan differs from the plain version on "
                             "integer LUTs")
    got, want = ops.pq_bulk_scan(luts, codes), ref.pq_scan_ref(luts, codes)
    sync(dev)
    if not torch.allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
        raise AssertionError("pq_scan differs from the plain version beyond "
                             "1e-5 on float LUTs")
    err = float((got - want).abs().max())
    del want
    # The library yardstick: one embedding_bag over codes offset by m * K
    # (index prepared outside the timing) gives the (N, Q) transpose.
    idx = codes.long() + torch.arange(PQ_M, device=dev) * PQ_K
    weight = luts.reshape(PQ_Q, PQ_M * PQ_K).T.contiguous()
    lib_out = F.embedding_bag(idx, weight, mode="sum")
    sync(dev)
    lib_err = float((lib_out.T - got).abs().max())
    del lib_out, got
    ms, host = time_calls(lambda: ops.pq_bulk_scan(luts, codes), hold=True)
    # The design's floor on the card: with all-zero codes the 8 lanes of a
    # quarter-warp read entries (0, m) of 8 different m, in 8 bank groups,
    # as they do for any codes; a slower random-code time would be bank
    # conflicts.
    zeros = torch.zeros_like(codes)
    if not torch.equal(ops.pq_bulk_scan(luts_i, zeros),
                       ref.pq_scan_ref(luts_i, zeros)):
        raise AssertionError("pq_scan differs from the plain version on "
                             "all-zero codes")
    floor_ms, _ = time_calls(lambda: ops.pq_bulk_scan(luts, zeros), hold=True)
    plain_ms, _ = time_calls(lambda: ref.pq_scan_ref(luts, codes),
                             hold=False, reps=5)
    lib_ms, _ = time_calls(lambda: F.embedding_bag(idx, weight, mode="sum"),
                           hold=False, reps=5)
    bound = bound_of(n * PQ_M + PQ_Q * PQ_M * PQ_K * 4 + PQ_Q * n * 4,
                     PQ_Q * n * PQ_M)
    # Shared memory's own floor: one 4-byte entry a lookup at 128 bytes a
    # cycle an SM, at the H100 SXM's top SM clock (1.98 GHz).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_ms = PQ_Q * n * PQ_M * 4 / (128 * sms * 1.98e9) * 1e3
    log(f"[phase2] pq_scan ({PQ_Q}, {PQ_M}, {PQ_K}) x ({n}, {PQ_M}): "
        f"integer LUTs bit for bit (random and all-zero codes), float LUTs "
        f"within 1e-5 (max abs err {err:.3g}); kernel {ms:.4f} ms on the "
        f"device ({host:.4f} ms host), all-zero codes (conflict-free floor) "
        f"{floor_ms:.4f} ms, bytes bound {bound[0]:.4f} ms ({bound[1]}), "
        f"shared-memory floor {smem_ms:.4f} ms at 1.98 GHz; plain "
        f"{plain_ms:.4f} ms, library (embedding_bag, max abs diff "
        f"{lib_err:.3g}) {lib_ms:.4f} ms")
    del codes, zeros, luts, luts_i, idx, weight
    rec = record("pq_scan", err, ms, plain_ms, lib_ms, bound,
                 "integer LUTs bit for bit (random and all-zero codes); "
                 "float LUTs within 1e-5")
    rec["zero_codes_ms"] = floor_ms
    rec["smem_floor_ms_at_1980mhz"] = smem_ms
    return rec


# ---------------------------------------------------------------- phase 3

def trace_report(prof, wall_ms: float, path: str) -> str:
    """Write the profile of one batch to ``path`` (+ ``.json``, a Chrome
    trace); return a one-line summary: wall ms, the device's busy ms (the
    union of its kernel and copy intervals) and the longest host
    operators."""
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.elapsed_us() > 0]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end, gap = 0.0, float("-inf"), (0.0, 0.0)
    for a, b in spans:
        if end > float("-inf") and a - end > gap[0]:
            gap = (a - end, end - spans[0][0])
        if b > end:
            busy += b - max(a, end)
            end = b
    avg = prof.key_averages()
    host = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:4]
    with open(path, "w") as f:
        f.write(f"wall {wall_ms:.3f} ms, device busy {busy / 1e3:.3f} ms "
                f"({len(events)} device events), longest device gap "
                f"{gap[0] / 1e3:.3f} ms at {gap[1] / 1e3:.3f} ms after the "
                f"first device event\n\n")
        f.write(avg.table(sort_by="self_cpu_time_total", row_limit=30))
        f.write("\n\nby self device time:\n")
        for e in sorted(avg, key=lambda e: e.self_device_time_total,
                        reverse=True)[:20]:
            f.write(f"{e.self_device_time_total / 1e3:9.3f} ms  "
                    f"{e.count:5d} calls  {e.key}\n")
    prof.export_chrome_trace(path[:-4] + ".json")
    return (f"wall {wall_ms:.1f} ms, device busy {busy / 1e3:.1f} ms, "
            f"longest device gap {gap[0] / 1e3:.1f} ms at "
            f"{gap[1] / 1e3:.1f} ms; "
            "host self ms: " + ", ".join(
                f"{e.key} {e.self_cpu_time_total / 1e3:.1f}" for e in host))


def serve_run(name, engine, batches, gts, n, pipelined: bool,
              trace: bool = False, keep: list | None = None):
    """Serve ``batches``; return the printed metrics.  ``trace``: profile
    the first batch (see :func:`trace_report`); ``keep`` collects the
    results."""
    import numpy as np
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    lat, recalls, hops, budgets = [], [], [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    t_all = t0 = time.perf_counter()
    results = (engine.search_batches(batches) if pipelined
               else (engine.search(b) for b in batches))
    for bi, res in enumerate(results):
        lat.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
            out = os.path.join(ROOT, "chiprun_out")
            os.makedirs(out, exist_ok=True)
            log(f"[trace] {name}, first batch: " + trace_report(
                prof, lat[0], os.path.join(out, "first_batch_trace.txt")))
            prof = None
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
        if keep is not None:
            keep.append(res)
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
        f"first={lat[0]:.1f}ms "
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
              seed: int, trace: bool = False):
    """Build and serve the deployment; returns the launch counts of this
    run (counts set to 0 at its start) and what the calibration path needs.
    ``trace``: profile the first batch of the tiered pipelined run."""
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
        f"lid_estimate); LID mu={float(graph.mu)!r} "
        f"sigma={float(graph.sigma)!r}")
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
            "tiered adaptive pipelined", eng_t, batches, gts, n, True,
            trace=trace),
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
    for name in MCGI_KERNELS:
        if counts[name] == 0:
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


# --------------------------------------------------------------- phase 3c

def adc_path(world) -> dict:
    """Bulk ADC retrieval over phase 3's PQ codes: ``adc_topk`` of the
    query stream in chunks, recall@10 against the exact ground truth, and
    one retrieval_cand-shaped call.  Returns the launch counts of this
    run."""
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import adc

    tiered = world["tiered"]
    codes = tiered.index.codes
    n = codes.shape[0]
    luts = tiered.admit(world["qn"])                   # (Q, 16, 256) LUTs
    sync(luts.device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vals, ids = adc.adc_topk(luts, codes, ADC_K)
    sync(luts.device)
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    nq = luts.shape[0]
    chunks = -(-nq // adc.query_chunk(n))
    if ids.shape != (nq, ADC_K) or not bool(((ids >= 0) & (ids < n)).all()):
        raise AssertionError(f"[adc] ids of shape {tuple(ids.shape)} or "
                             f"outside [0, {n})")
    if not (bool(torch.isfinite(vals).all())
            and bool((vals[:, 1:] >= vals[:, :-1]).all())):
        raise AssertionError("[adc] distances not finite and ascending")
    for name in ("pq_scan", "topk"):
        if counts[name] != chunks:
            raise AssertionError(f"[adc] {name} launched {counts[name]} "
                                 f"times, not once per chunk ({chunks})")
    # The path's kernels against their plain versions at its two shapes:
    # its first chunk (the path's own results, no new launch) and one
    # retrieval_cand call; values and ids must be identical.
    chunk = min(adc.query_chunk(n), nq)
    one = luts[:1].contiguous()
    for what, lq, (got_v, got_i) in (
            (f"a chunk of {chunk} queries", luts[:chunk],
             (vals[:chunk], ids[:chunk])),
            ("one query", one, adc.adc_topk(one, codes, ADC_K))):
        want_v, want_i = ref.topk_ref(ref.pq_scan_ref(lq, codes), ADC_K)
        sync(luts.device)
        if not (torch.equal(got_v, want_v) and torch.equal(got_i, want_i)):
            raise AssertionError(f"[adc] pq_scan + topk on {what} differ "
                                 f"from pq_scan_ref + topk_ref")
        del want_v, want_i
    recall = float(distance.recall_at_k(ids.cpu(),
                                        torch.as_tensor(world["gt"])))
    log(f"[adc] adc_topk k={ADC_K}: {nq} queries x {n} PQ codes "
        f"(m={codes.shape[1]}) in {chunks} chunks of "
        f"{adc.query_chunk(n)}: {secs:.3f}s ({nq / secs:.1f} QPS); values "
        f"and ids of the first chunk and of a 1-query call identical to "
        f"pq_scan_ref + topk_ref; "
        f"recall@10 {recall:.4f} against the exact ground truth "
        f"(exhaustive ADC, no rerank; tiered serving reranks); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    ms, host = time_calls(lambda: adc.adc_topk(one, codes, ADC_K), hold=True)
    log(f"[adc] retrieval_cand shape (1 query x {n} candidates, k={ADC_K}): "
        f"{ms:.4f} ms on the device per call ({host:.4f} ms host)")
    # Recall@100's k over the first chunk, after the launch counts are read.
    wv, wi = adc.adc_topk(luts[:chunk], codes, ADC_K_WIDE)
    want_v, want_i = ref.topk_ref(ref.pq_scan_ref(luts[:chunk], codes),
                                  ADC_K_WIDE)
    sync(luts.device)
    if not (torch.equal(wv, want_v) and torch.equal(wi, want_i)):
        raise AssertionError(f"[adc] adc_topk k={ADC_K_WIDE} on a chunk of "
                             f"{chunk} queries differs from pq_scan_ref + "
                             f"topk_ref")
    if not (torch.equal(wv[:, :ADC_K], vals[:chunk])
            and torch.equal(wi[:, :ADC_K], ids[:chunk])):
        raise AssertionError(f"[adc] the first {ADC_K} of k={ADC_K_WIDE} "
                             f"differ from the k={ADC_K} run")
    ms, host = time_calls(lambda: adc.adc_topk(luts[:chunk], codes,
                                               ADC_K_WIDE), hold=True)
    log(f"[adc] adc_topk k={ADC_K_WIDE} on the first chunk ({chunk} "
        f"queries): values and ids identical to pq_scan_ref + topk_ref, "
        f"its first {ADC_K} to the k={ADC_K} run's; {ms:.4f} ms on the "
        f"device per call ({host:.4f} ms host)")
    del luts, vals, ids, wv, wi, want_v, want_i
    return counts


# --------------------------------------------------------------- phase 3d

def disk_served(name, engine, tier, world, want, pipelined: bool) -> dict:
    """Serve phase 3's stream with the slow tier on disk; every batch's ids
    and d2 must equal the in-memory tiered run's bit for bit.  Prints the
    serving metrics and the tier's measured figures."""
    import numpy as np

    tier.reset_stats()
    got: list = []
    m = serve_run(name, engine, world["batches"], world["gts"], world["n"],
                  pipelined, keep=got)
    for bi, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.ids, w.ids) and np.array_equal(g.d2, w.d2)):
            raise AssertionError(f"[disk] {name}: batch {bi} differs from "
                                 f"the in-memory tiered run")
    st, lat = tier.stats(), tier.fetch_latency_us()
    nq = sum(b.shape[0] for b in world["batches"])
    m.update(st, **lat, io_blocks_per_query=st["io_blocks"] / nq,
             fetch_share=lat["fetch_p50_us"] / 1e3 / m["p50_ms"])
    log(f"[disk] {name}: ids and d2 bit-identical to the in-memory tiered "
        f"run; qps={m['qps']:.1f} batch p50={m['p50_ms']:.2f}ms "
        f"p99={m['p99_ms']:.2f}ms recall@10={m['recall']:.4f} "
        f"hit_rate={st['hit_rate']:.4f} blocks_read={st['blocks_read']} "
        f"io_blocks/query={m['io_blocks_per_query']:.2f} "
        f"measured_read_us={st['measured_read_us']:.3f} "
        f"fetch p50={lat['fetch_p50_us']:.0f}us "
        f"p99={lat['fetch_p99_us']:.0f}us ({lat['fetch_samples']} fetches; "
        f"fetch p50 / batch p50 = {m['fetch_share']:.3f}); reads come from "
        "the OS page cache (the store was just written), not SSD latencies")
    return m


def disk_path(world) -> dict:
    """The disk-resident slow tier at phase 3's 1M index: stores written to
    a temporary directory, the stream served pipelined and per batch, with a
    hot tier, from a packed store, and from a saved and reloaded v2 index,
    each bit-identical to the in-memory tiered run.  Returns the launch
    counts of the disk runs."""
    import shutil
    import tempfile

    import torch

    from repro_torch import serving
    from repro_torch.core import build
    from repro_torch.index import (load_index, load_slow_tier,
                                   open_or_build_slow_tier, save_index)
    from repro_torch.index.serializer import blocks_path
    from repro_torch.kernels import ops

    cfg = sift1m()
    index = world["tiered"].index
    budget = cfg.beam_budget()
    want: list = []
    mem = serve_run("in-memory tiered adaptive pipelined (the [disk] "
                    "reference)", serving.SearchEngine(world["tiered"],
                                                       budget, k=cfg.k),
                    world["batches"], world["gts"], world["n"], True,
                    keep=want)
    tmp = tempfile.mkdtemp(prefix="mcgi-disk-")
    log(f"[disk] stores in {tmp} (removed when the phase ends)")
    tiers = []

    def tier_engine(tier, idx=index):
        tiers.append(tier)
        return serving.SearchEngine(
            serving.TieredBackend(idx, slow_tier=tier, device=idx.device),
            budget, k=cfg.k)

    def disk_log(msg):
        log(f"[disk] {msg}")

    try:
        ops.reset_launch_counts()
        runs = {}
        node_path = os.path.join(tmp, "sift1m.blocks")
        t0 = time.perf_counter()
        tier = open_or_build_slow_tier(node_path, index, cache_nodes=4096,
                                       pin_nodes=256, log=disk_log)
        secs = time.perf_counter() - t0
        size = os.path.getsize(node_path)
        log(f"[disk] node-order store: {size} bytes "
            f"({tier.store.block_size} B records, {tier.store.n} nodes) "
            f"written and opened in {secs:.2f}s; cache_nodes=4096 "
            f"pin_nodes=256")
        eng = tier_engine(tier)
        eng.search(world["qn"][:64])                       # warm-up
        runs["pipelined"] = disk_served("node order, pipelined", eng, tier,
                                        world, want, True)
        runs["per_batch"] = disk_served("node order, per batch", eng, tier,
                                        world, want, False)
        mtime = os.stat(node_path).st_mtime_ns
        hot = open_or_build_slow_tier(node_path, index, cache_nodes=4096,
                                      pin_nodes=256, hot_nodes=65536,
                                      log=disk_log)
        if os.stat(node_path).st_mtime_ns != mtime:
            raise AssertionError("[disk] a second open_or_build_slow_tier "
                                 "rewrote the store")
        log("[disk] second open_or_build_slow_tier on the same path reused "
            "the store (mtime unchanged)")
        eng = tier_engine(hot)
        for p in (1, 2):
            runs[f"hot_pass{p}"] = disk_served(
                f"hot tier 65536, pass {p}, pipelined", eng, hot, world,
                want, True)
            hot.drain_promotions()
            st = hot.stats()
            log(f"[disk] hot tier after pass {p}: resident "
                f"{st['hot_nodes']}/{st['hot_capacity']} hot_hits="
                f"{st['hot_hits']} promotions={st['promotions']} "
                f"demotions={st['demotions']} ticks={st['promotion_ticks']} "
                f"promotion_io_blocks={st['promotion_io_blocks']}")
        t0 = time.perf_counter()
        slot_of = build.block_layout(index.graph, nodes_per_block=4)
        t_layout = time.perf_counter() - t0
        packed_path = os.path.join(tmp, "sift1m-packed.blocks")
        t0 = time.perf_counter()
        packed = open_or_build_slow_tier(packed_path, index,
                                         cache_nodes=4096, pin_nodes=256,
                                         nodes_per_block=4, slot_of=slot_of,
                                         log=disk_log)
        log(f"[disk] block_layout (greedy_block_pack, 4 x 1 KiB records a "
            f"4 KiB page) in {t_layout:.2f}s; packed store "
            f"{os.path.getsize(packed_path)} bytes written in "
            f"{time.perf_counter() - t0:.2f}s")
        runs["packed"] = disk_served("packed 4 a page, pipelined",
                                     tier_engine(packed), packed, world,
                                     want, True)
        log(f"[disk] io_blocks/query: node order "
            f"{runs['pipelined']['io_blocks_per_query']:.2f}, packed "
            f"{runs['packed']['io_blocks_per_query']:.2f}")
        os.remove(packed_path)
        npz = os.path.join(tmp, "sift1m.npz")
        t0 = time.perf_counter()
        save_index(npz, index, version=2)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_index(npz, device=index.device)
        t_load = time.perf_counter() - t0
        for name, a, b in (
                ("adj", index.graph.adj, loaded.graph.adj),
                ("entry", index.graph.entry, loaded.graph.entry),
                ("alpha", index.graph.alpha, loaded.graph.alpha),
                ("lid", index.graph.lid, loaded.graph.lid),
                ("mu", index.graph.mu, loaded.graph.mu),
                ("sigma", index.graph.sigma, loaded.graph.sigma),
                ("centroids", index.codebook.centroids,
                 loaded.codebook.centroids),
                ("codes", index.codes, loaded.codes),
                ("vectors", index.vectors, loaded.vectors)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"[disk] v2 round trip changed {name}")
        log(f"[disk] save_index(version=2): npz "
            f"{os.path.getsize(npz)} bytes + sidecar "
            f"{os.path.getsize(blocks_path(npz))} bytes in {t_save:.2f}s; "
            f"load_index on the card in {t_load:.2f}s: every array equal")
        v2_tier = load_slow_tier(npz)
        runs["v2"] = disk_served("load_slow_tier of the v2 index, pipelined",
                                 tier_engine(v2_tier, loaded), v2_tier,
                                 world, want, True)
        counts = ops.launch_counts()
    finally:
        for t in tiers:
            t.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[disk] in-memory qps {mem['qps']:.1f} against disk-served "
        f"pipelined {runs['pipelined']['qps']:.1f} and per batch "
        f"{runs['per_batch']['qps']:.1f}; kernel launches on the disk "
        f"path: { {k: v for k, v in counts.items() if v} }")
    if counts["beam_step.pq"] == 0:
        raise AssertionError("[disk] beam_step.pq was never launched on the "
                             "disk path")
    return counts


# ------------------------------------------------------------- phase 4: LM

def lm_params(dev, seed: int):
    """qwen2-7b's parameters at full width, drawn in bfloat16 on the card."""
    import torch

    from repro_torch.models import transformer

    cfg = qwen2()
    g = torch.Generator(device=dev).manual_seed(seed + 505)
    t0 = time.perf_counter()
    params = transformer.init_lm(cfg, g, device=dev)
    sync(dev)
    n = cfg.n_params()
    log(f"[lm] {cfg.name} at full width: {n} parameters in {cfg.dtype} "
        f"({n * 2 / 1e9:.2f} GB) drawn from --seed in "
        f"{time.perf_counter() - t0:.1f}s")
    return params


def step_stats(ms: list) -> str:
    import numpy as np

    return (f"p50 {float(np.percentile(ms, 50)):.3f} ms, p99 "
            f"{float(np.percentile(ms, 99)):.3f} ms")


def step_bound(params, b: int, kv_len: int) -> str:
    """Least time of one decode step: every weight read once (of the
    embedding only the B rows looked up) and the K/V cache up to kv_len of
    every layer, at the HBM rate."""
    from repro_torch.models import transformer

    cfg = qwen2()
    weights = sum(t.numel() * t.element_size()
                  for t in transformer.leaves(params)) - (
        params["embed"].numel() - b * cfg.d_model) * 2
    kv = b * kv_len * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head * 2
    ms = (weights + kv) / HBM_BYTES_PER_S * 1e3
    return (f"{ms:.3f} ms ({(weights + kv) / 1e9:.1f} GB of weights and "
            f"cache at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def aten_calls(fn) -> int:
    """Calls into PyTorch's operator library (views included) that one
    ``fn()`` makes: what the host dispatches for it, independent of the
    card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def lm_serve(params, dev, seed: int) -> dict:
    """[lm-serve]: teacher-force LM_BATCH prompts of LM_PROMPT tokens
    through ``decode_step``, then generate greedily to LM_GEN tokens a row;
    check prefill against the decode path, decode_attention's outputs
    against its plain version, and that a second run generates the same
    tokens.  Returns the launch counts of the first run and the kernel's
    max abs error."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = qwen2()
    g = torch.Generator(device=dev).manual_seed(seed + 606)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                            device=dev)
    max_len = LM_PROMPT + LM_GEN
    seen, step = {}, [0]

    def spy(q, k, v, kv_len):
        """ops.decode_attention that keeps layer 0's inputs and output at
        the steps of LM_CHECK_STEPS (it adds copies, no launch)."""
        out = real(q, k, v, kv_len)
        if step[0] in LM_CHECK_STEPS and step[0] not in seen:
            seen[step[0]] = tuple(x.clone() for x in (q, k, v, kv_len, out))
        return out

    def generate():
        cache = transformer.init_cache(cfg, LM_BATCH, max_len, device=dev)
        step_ms, tokens, last = [], [], None
        feed = prompts[:, :1]
        for t in range(LM_PROMPT + LM_GEN - 1):
            step[0] = t
            lens = torch.full((LM_BATCH,), t, dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(cfg, params, cache, feed,
                                                    lens)
            nxt = logits.argmax(-1)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if t == LM_PROMPT - 1:
                last = logits.float()
            if t >= LM_PROMPT - 1:
                tokens.append(nxt)
            feed = (prompts[:, t + 1:t + 2] if t + 1 < LM_PROMPT
                    else nxt[:, None])
        return torch.stack(tokens, 1), last, step_ms

    real = ops.decode_attention
    ops.decode_attention = spy
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, last, step_ms = generate()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        ops.decode_attention = real
    steps = LM_PROMPT + LM_GEN - 1
    # The kernel's own outputs on this path against the plain version on
    # the same tensors: layer 0 at a teacher-forced and a generated step.
    if sorted(seen) != sorted(LM_CHECK_STEPS):
        raise AssertionError(f"[lm-serve] decode_attention inputs kept at "
                             f"steps {sorted(seen)}, not {LM_CHECK_STEPS}")
    attn_err = max(attention_check(f"lm-serve step {t}", *seen[t][:4],
                                   got=seen[t][4]) for t in LM_CHECK_STEPS)
    del seen
    if counts["decode_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"[lm-serve] decode_attention launched "
                             f"{counts['decode_attention']} times, not "
                             f"{cfg.n_layers} per step x {steps} steps")
    if toks.shape != (LM_BATCH, LM_GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"[lm-serve] generated tokens of shape "
                             f"{tuple(toks.shape)} or outside the vocabulary")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError("[lm-serve] non-finite logits")
    t0 = time.perf_counter()
    pre = transformer.prefill(cfg, params, prompts).float()
    sync(dev)
    pre_ms = (time.perf_counter() - t0) * 1e3
    rel = float((pre - last).norm() / last.norm())
    if not rel <= PREFILL_REL_L2:
        raise AssertionError(f"[lm-serve] prefill vs decode logits at "
                             f"position {LM_PROMPT - 1}: relative L2 "
                             f"{rel:.4g} > {PREFILL_REL_L2}")
    toks2, _, _ = generate()
    if not torch.equal(toks, toks2):
        raise AssertionError("[lm-serve] a second generation gave other "
                             "tokens")
    cache = transformer.init_cache(cfg, LM_BATCH, max_len, device=dev)
    calls = aten_calls(lambda: transformer.decode_step(
        cfg, params, cache, prompts[:, :1],
        torch.zeros((LM_BATCH,), dtype=torch.int32, device=dev)))
    del cache
    gen_ms = step_ms[LM_PROMPT:]
    gen_rate = LM_BATCH * len(gen_ms) / (sum(gen_ms) / 1e3)
    log(f"[lm-serve] {LM_BATCH} prompts x {LM_PROMPT} tokens teacher-forced "
        f"through decode_step, then {LM_GEN} greedy tokens a row ({steps} "
        f"steps into a cache of {LM_PROMPT + LM_GEN}) in {secs:.2f}s; step "
        f"{step_stats(step_ms)} (bound at the full cache "
        f"{step_bound(params, LM_BATCH, max_len)}); generation "
        f"{gen_rate:.1f} tokens/s ({step_stats(gen_ms)}); prefill of {LM_BATCH}x{LM_PROMPT} "
        f"in {pre_ms:.1f} ms, its last logits within relative L2 {rel:.3g} "
        f"of the decode path's (bound {PREFILL_REL_L2}); the second run "
        f"generated identical tokens; decode_attention's outputs at layer 0 "
        f"of steps {LM_CHECK_STEPS} (kv_len {[t + 1 for t in LM_CHECK_STEPS]}) "
        f"within {attn_err:.3g} of the plain version (bound {ATTN_TOL}); "
        f"one step makes {calls} aten calls "
        f"(views included); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts, attn_err


def lm_cell(params, dev, seed: int, cell: str, b: int, s: int) -> dict:
    """[lm-<cell>]: LM_CELL_STEPS decode steps at kv_len = S - 1 against a
    cache of random bfloat16 values.  Returns the launch counts of the
    timed steps."""
    import torch

    from repro_torch.configs import qwen2_7b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = qwen2()
    full_b = qwen2_7b.SPEC.cell(cell).meta["batch"]
    if b < full_b:
        full_kv = full_b * s * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head
        log(f"[lm-{cell}] batch cut: {full_b} -> {b} (the cell's KV cache, "
            f"{full_kv * 2 / 2**30:.0f} GiB, fits no card)")
    g = torch.Generator(device=dev).manual_seed(seed + 707)
    t0 = time.perf_counter()
    cache = transformer.init_cache(cfg, b, s, device=dev)
    for name in ("k", "v"):
        for i in range(cfg.n_layers):
            cache[name][i].normal_(generator=g)
    sync(dev)
    fill_s = time.perf_counter() - t0
    lens = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev)
    for _ in range(2):                                    # warm-up
        transformer.decode_step(cfg, params, cache, tokens, lens)
    sync(dev)
    ops.reset_launch_counts()
    step_ms = []
    for _ in range(LM_CELL_STEPS):
        t0 = time.perf_counter()
        logits, cache = transformer.decode_step(cfg, params, cache, tokens,
                                                lens)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    if counts["decode_attention"] != cfg.n_layers * LM_CELL_STEPS:
        raise AssertionError(f"[lm-{cell}] decode_attention launched "
                             f"{counts['decode_attention']} times, not "
                             f"{cfg.n_layers} per step")
    if logits.shape != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[lm-{cell}] logits of shape "
                             f"{tuple(logits.shape)} or not finite")
    # decode_attention alone on layer 0's cache at the step's shape.
    q = torch.randn((b, cfg.n_heads, cfg.d_head), generator=g,
                    device=dev).bfloat16()
    ms, _ = time_calls(lambda: ops.decode_attention(
        q, cache["k"][0], cache["v"][0], lens + 1), hold=True)
    attn_bound = attention_bound(lens + 1, s, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.d_head, 2)
    p50 = sorted(step_ms)[len(step_ms) // 2]
    log(f"[lm-{cell}] B={b} S={s} kv_len=S-1, cache filled in {fill_s:.1f}s; "
        f"{LM_CELL_STEPS} steps: {step_stats(step_ms)}, "
        f"{b / (p50 / 1e3):.1f} tokens/s at p50; step bound "
        f"{step_bound(params, b, s)}; decode_attention "
        f"{ms:.4f} ms on the device per launch (bound {attn_bound[0]:.4f} "
        f"ms), {cfg.n_layers} launches a step = "
        f"{100 * cfg.n_layers * ms / p50:.1f}% of the p50 step; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del cache
    torch.cuda.empty_cache()
    return counts


def lm_paths(dev, seed: int) -> tuple[dict, float]:
    """Every LM path; returns ({path: launch counts}, decode_attention's max
    abs error on [lm-serve])."""
    import torch

    params = lm_params(dev, seed)
    out = {}
    out["lm-serve"], attn_err = lm_serve(params, dev, seed)
    torch.cuda.empty_cache()
    for cell, b, s in LM_CELLS:
        out[f"lm-{cell}"] = lm_cell(params, dev, seed, cell, b, s)
    del params
    torch.cuda.empty_cache()
    return out, attn_err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="base points of the main path (1M = SIFT1M; "
                         "a smaller N is printed as a cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-first-batch", action="store_true",
                    help="profile the first batch of the tiered adaptive "
                         "pipelined run into chiprun_out/")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
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
    kernels.append(check_pq_scan(dev, args.seed))
    torch.cuda.empty_cache()
    kernels.append(check_decode_attention(dev, args.seed))
    torch.cuda.empty_cache()

    paths = {}
    paths["main"], world = main_path(dev, args.n, N_QUERIES, SERVE_BATCH,
                                     BUILD_BATCH, args.seed,
                                     trace=args.trace_first_batch)
    paths["calibration"] = calibration_path(world)
    paths["adc"] = adc_path(world)
    paths["disk"] = disk_path(world)
    del world
    torch.cuda.empty_cache()
    lm_counts, attn_err = lm_paths(dev, args.seed)
    paths.update(lm_counts)
    for rec in kernels:
        if rec["name"] == "decode_attention":
            rec["max_abs_err"] = max(rec["max_abs_err"], attn_err)
    # Each kernel's launches are read on the path that runs it.
    home = {"pq_scan": "adc", "decode_attention": "lm-serve"}
    for rec in kernels:
        rec["launches"] = paths[home.get(rec["name"], "main")][rec["name"]]
        rec["path_launches"] = {p: c[rec["name"]] for p, c in paths.items()}
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was never launched on its "
                                 f"path")
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s "
        f"(kernel build included)")
    log("kernels: " + json.dumps({r["name"]: {
        "launches": r["launches"], "path_launches": r["path_launches"],
        "phase2": r["verdict"]} for r in kernels}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
