#!/usr/bin/env python3
"""Where ``l2_distance``'s time goes on one NVIDIA H100, and what its
rounding does to the LID k-NN.

    python3 chip_l2_study.py            # from the repository root, on the card

1. Builds ``src/repro_torch/csrc/l2_distance.cu`` as it is and in variants
   with one piece of the float32 kernel's work taken out (a variant's
   results are wrong by design; only its time is read), each with nvcc into
   ``build/l2_study/``, all started together, and times each at the LID
   k-NN's shape (4096 x 65536 x 128 float32; CUDA events, median of 5
   rounds of the mean of 20 launches):

   * ``full``: the kernel as it is;
   * ``products_only``: no splits, no loads after the prologue, no stores:
     the tensor cores' three TF32 products of every slice and the partials;
   * ``no_products``: everything but the ``wgmma`` products;
   * ``no_stores``: everything but the output stores;
   * ``one_product``: big.big only, one TF32 product a k-step instead of
     three;
   * ``no_partials``: the three products of every k-step straight into the
     accumulators, without a partial per slice;

   for ``full`` and ``no_partials`` also the largest absolute error against
   float64 on SIFT-scale near duplicates (coordinates in [0, 255], 1024
   queries against a near duplicate of each, every coordinate moved by up
   to 40, and 7168 far points), beside the plain float32 version's; and
   counts the tensor-core instructions in the SASS of the library as it is
   (``cuobjdump -sass``).

2. The LID k-NN (k = 16) of the first 200,000 points of the
   ``mcgi-sift1m`` data through the kernels (``l2_distance`` + ``topk``)
   and through their plain versions on the card (``torch.matmul`` in full
   float32 + ``torch.topk``), each against the exact k-NN in float64: rows
   whose k-NN ids differ, the largest absolute and relative error of a
   k-NN distance and of a point's LID, and the population (mu, sigma).

Prints the card's name and power limit first; needs one CUDA card.

    python3 chip_l2_study.py --lid-only --src OTHER/src

runs part 2 alone on the package under OTHER/src (another checkout's
kernels), against the same plain versions.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src/repro_torch/csrc/l2_distance.cu")
OUT = os.path.join(ROOT, "build/l2_study")
Q, N, D = 4096, 65536, 128
LID_POINTS, LID_K = 200_000, 16

_CROSS = ("      wgmma_tf32(p, asl[kk], core_desc(sp + kk * 1024), kk > 0);\n"
          "      wgmma_tf32(p, ab[kk], core_desc(sp + kBN * kBK + kk * 1024), "
          "1);\n")
_BIG = ("    for (int kk = 0; kk < 4; ++kk) "
        "wgmma_tf32(p, ab[kk], core_desc(sp + kk * 1024), 1);\n")
_SPLIT = ("      split_base(smem + slot * Slice<float>::kWords, "
          "split + ((s + 1) & 1) * kSplitWords);\n")
_LOAD = "      if (s + kSlots < steps) ld.next(smem, norms_s);\n"
_STORE = "        store_frag(acc + 4 * j,"
_PARTIAL = ("    hold(p);\n",
            "    for (int i = 0; i < 64; ++i) acc[i] += p[i];\n")
_NO_STORE = "        if (nq < 0) store_frag(acc + 4 * j,"
# Each variant: (text in the float32 kernel, its replacement).
VARIANTS = {
    "full": [],
    "products_only": [(_SPLIT, ""), (_LOAD, ""), (_STORE, _NO_STORE)],
    "no_products": [(_CROSS, ""), (_BIG, "")],
    "no_stores": [(_STORE, _NO_STORE)],
    "one_product": [(_CROSS, ""), (_BIG, _BIG.replace(", 1);", ", kk > 0);"))],
    "no_partials": [(_CROSS, _CROSS.replace("(p,", "(acc,")
                     .replace("kk > 0", "1")),
                    (_BIG, _BIG.replace("(p,", "(acc,")),
                    (_PARTIAL[0], "    hold(acc);\n"), (_PARTIAL[1], "")],
}
# Variants whose results are right, or meant to be compared for precision.
PRECISION = ("full", "no_partials")


def log(msg: str) -> None:
    print(msg, flush=True)


def build_variants() -> dict:
    """Write and compile every variant at once; returns name -> C entry."""
    os.makedirs(OUT, exist_ok=True)
    base = open(SRC).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel no longer "
                                   f"holds {old.strip()!r}")
            text = text.replace(old, new)
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        cmd = [_nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
               os.path.join(OUT, f"{name}.so"), src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).repro_l2_distance
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _nvcc_path() -> str:
    from repro_torch.kernels import _build

    return _build._nvcc()


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[rounds // 2]


def study_time(dev) -> None:
    import torch

    fns = build_variants()
    cuobjdump = os.path.join(os.path.dirname(_nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", os.path.join(OUT, "full.so")],
                          capture_output=True, text=True).stdout
    log(f"[l2-study] SASS of the kernel library: {sass.count('HGMMA')} "
        f"HGMMA (wgmma), {sass.count('HMMA')} HMMA (mma.sync) instructions")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((Q, D), generator=g, device=dev)
    x = torch.randn((N, D), generator=g, device=dev)
    out = torch.empty((Q, N), device=dev)
    norms = torch.empty(Q + N, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn, a, b):
        o = torch.empty((a.shape[0], b.shape[0]), device=dev)
        nr = torch.empty(a.shape[0] + b.shape[0], device=dev)
        rc = fn(0, a.shape[0], b.shape[0], a.shape[1], a.data_ptr(),
                b.data_ptr(), nr.data_ptr(), o.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return o

    from repro_torch.kernels import ref

    sq = torch.rand((1024, D), generator=g, device=dev) * 255
    near = sq + (torch.rand(sq.shape, generator=g, device=dev) - 0.5) * 80
    sx = torch.cat([near.clamp(0, 255),
                    torch.rand((7168, D), generator=g, device=dev) * 255])
    q64, x64 = sq.double(), sx.double()
    truth = ((q64 * q64).sum(1, keepdim=True) - 2 * q64 @ x64.T
             + (x64 * x64).sum(1)).clamp_min(0)
    plain = float((ref.l2_distance_ref(sq, sx).double() - truth).abs().max())
    for name, fn in fns.items():
        def call(fn=fn):
            rc = fn(0, Q, N, D, q.data_ptr(), x.data_ptr(), norms.data_ptr(),
                    out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        err = ""
        if name in PRECISION:
            e = float((run(fn, sq, sx).double() - truth).abs().max())
            err = (f"; SIFT-scale near duplicates: max abs err {e:.3g} "
                   f"(plain float32 {plain:.3g})")
        log(f"[l2-study] {name}: {time_ms(call):.4f} ms at {Q}x{N}x{D} "
            f"float32{err}")


def exact_knn(x, k: int, chunk: int = 4096):
    """The k-NN of every row of x in float64 (self excluded): (N, k)
    ascending squared distances and ids."""
    import torch

    x64 = x.double()
    xn = (x64 * x64).sum(1)
    ds, ids = [], []
    for s in range(0, x.shape[0], chunk):
        q = x64[s:s + chunk]
        d = ((q * q).sum(1, keepdim=True) - 2 * q @ x64.T + xn).clamp_min(0)
        rows = torch.arange(q.shape[0], device=x.device)
        d[rows, rows + s] = torch.inf
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ds.append(v)
        ids.append(i.int())
    return torch.cat(ds), torch.cat(ids)


def study_lid(dev) -> None:
    import torch

    from repro_torch.core import distance
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.kernels import ops, ref

    x, _ = make_dataset(REGISTRY["sift1m"], seed=0, device=dev,
                        n=LID_POINTS)
    paths = {"kernels": distance.knn_graph(x, LID_K, chunk_q=4096)}
    kernels = ops.bulk_l2, ops.topk
    try:
        ops.bulk_l2, ops.topk = ref.l2_distance_ref, ref.topk_ref
        paths["plain"] = distance.knn_graph(x, LID_K, chunk_q=4096)
    finally:
        ops.bulk_l2, ops.topk = kernels
    ed, ei = exact_knn(x, LID_K)
    el = ref.lid_ref(ed.float()).double()
    log(f"[l2-study] LID k-NN of {LID_POINTS} points (k={LID_K}), float64: "
        f"mu={float(el.mean()):.6f} sigma={float(el.std(unbiased=False)):.6f}")
    for name, (d, i) in paths.items():
        rows = int((i != ei).any(1).sum())
        err = (d.double() - ed).abs()
        lid = ref.lid_ref(d).double()
        log(f"[l2-study] LID k-NN through the {name}: {rows} rows whose ids "
            f"differ from float64's ({rows / LID_POINTS:.6f}); distances: "
            f"max abs err {float(err.max()):.4g}, max relative err "
            f"{float((err / ed.clamp_min(1e-30)).max()):.4g}; LID: max "
            f"relative err {float(((lid - el).abs() / el).max()):.4g}, "
            f"mu={float(lid.mean()):.6f} "
            f"sigma={float(lid.std(unbiased=False)):.6f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory that holds the repro_torch package")
    ap.add_argument("--lid-only", action="store_true",
                    help="run part 2 (the LID k-NN) alone")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_l2_study: no CUDA device; this study runs on the card "
              "only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    if not args.lid_only:
        study_time(dev)
    study_lid(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
