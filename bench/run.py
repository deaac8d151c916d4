"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It exits non-zero and prints no result when
no CUDA card is available (or fewer than the cell asks for), when the
program (``src/repro_torch``) is missing, or when a module of JAX or the JAX
package is loaded once the window has closed.  Otherwise the last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
``checks``, each number compared beside its limit); the same checks are the
last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Kernel and build caches at fixed paths inside the checkout.
CACHE = ROOT / "build" / "bench_cache"
# glibc's malloc parameters (mallopt), fixed as a serving process sets
# them: the engine makes its host buffers anew each batch, and with the
# default dynamic thresholds glibc hands the heap's top back to the kernel
# and faults it in again, in some processes and not others, so runs of one
# tree paced 16 or 22 ms a batch at random (PERF.md).
MALLOPT = {-1: 1 << 30,          # M_TRIM_THRESHOLD: keep freed heap
           -2: 1 << 28,          # M_TOP_PAD: grow the heap in 256 MiB
           -3: 1 << 25}          # M_MMAP_THRESHOLD: heap below 32 MiB


def set_malloc() -> None:
    import ctypes
    import ctypes.util

    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    for param, value in MALLOPT.items():
        if libc.mallopt(param, value) != 1:
            raise OSError(f"mallopt({param}, {value}) refused")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_malloc()

    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness, spec

    cell = spec.resolve(ROOT, args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA card: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible")
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        harness.log(f"modules of JAX or the JAX package loaded: {found}")
        return 3
    if args.trace:
        harness.log(f"card: {harness.card_power()}")
    for line in out.pop("_check_lines"):
        harness.log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
