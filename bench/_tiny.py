"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests hold: a few
thousand rows, a narrow graph, 100-query batches.  Only the sizes change;
the generator, the system, the checks and their limits are the cell's."""
from __future__ import annotations

import copy
import pathlib
import time

import torch

from bench import harness, spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
SECONDS = 0.6
# A traced run profiles on the CPU, many times slower.
TRACED_SECONDS = 2.5


def config(workload: str) -> dict:
    cfg = copy.deepcopy(spec.resolve(ROOT, workload).config)
    cfg["data"].update(n=1500, d=min(cfg["data"]["d"], 30), queries=200,
                       d_intrinsic=6, n_clusters=4)
    cfg["build"].update(degree=16, l_build=32, batch=256, max_hops=64)
    cfg["serve"].update(l_search=32)
    return cfg


def traffic(workload: str) -> dict:
    return dict(spec.resolve(ROOT, workload).traffic, batch=100,
                warmup_batches=2, trace_skip_batches=1, trace_batches=1)


def run(workload: str, seed: int = 7, traced: bool = False) -> dict:
    """One run of ``workload`` at the tiny size on the CPU."""
    return harness.run_cell(ROOT, workload, seed,
                            TRACED_SECONDS if traced else SECONDS, traced,
                            torch.device("cpu"), time.perf_counter(),
                            config=config(workload),
                            traffic_mix=traffic(workload))
