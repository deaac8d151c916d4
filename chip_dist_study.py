#!/usr/bin/env python3
"""Where [dist]'s batch time goes on one card: chip_smoke.py's sharded 1M
index (8 shards of 125,000 on a (2, 4) mesh, PQ m=16, the sift1m config's
law) served three ways in one process, in turns.

    python3 chip_dist_study.py [--parent DIR] [--n N] [--rounds R]
    python3 chip_dist_study.py --device cpu --n 4000 --parent DIR  # rehearsal

Variants:
  streams  this tree: each shard's walks on its own stream (the mesh's);
  one      this tree with one stream for every shard: the shards' walks
           one after another, the rest of the code path unchanged;
  parent   ``src/repro_torch/distributed/sharded_search.py`` of the
           checkout at DIR (e.g. a ``git archive`` of the parent commit),
           loaded from its file over this tree's other modules and fed the
           shard-major arrays: the one-stream serial walk as it was.
Each round serves the 10 batches of 1,000 queries staged (one ``search`` a
batch) and monolithic with every variant, in the order streams, one,
parent, then the reverse, and profiles one staged batch of each
(``torch.profiler``): wall ms, the device's busy ms (the union of its
kernel and copy intervals), the walk kernel's summed device ms and
launches.  The three must return the same ids and d2.  One JSON line a
variant and round (batch p50 / p99 ms by the host clock, each batch ending
in its host read of the results); the card's name and power limit first.
Needs one CUDA card.
"""
import argparse
import copy
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_parent(path: str):
    """The parent's sharded_search module, importing this tree's others."""
    spec = importlib.util.spec_from_file_location(
        "parent_sharded_search",
        os.path.join(path, "src/repro_torch/distributed/sharded_search.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_batch(engine, batch) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.search(batch)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(batch)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.elapsed_us() > 0]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    walk = [e for e in events if "beam" in e.name.lower()
            or "walk" in e.name.lower()]
    return dict(wall_ms=wall, busy_ms=busy / 1e3,
                walk_ms=sum(e.time_range.elapsed_us() for e in walk) / 1e3,
                walk_launches=len(walk))


def serve(engine, batches) -> tuple[dict, list]:
    import numpy as np

    lat, out = [], []
    t_all = time.perf_counter()
    for b in batches:
        t0 = time.perf_counter()
        res = engine.search(b)
        lat.append((time.perf_counter() - t0) * 1e3)
        out.append(res)
    secs = time.perf_counter() - t_all
    return (dict(p50_ms=float(np.percentile(lat, 50)),
                 p99_ms=float(np.percentile(lat, 99)),
                 qps=sum(b.shape[0] for b in batches) / secs), out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose sharded_search is the serial one")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of the control flow (its times "
                         "are the CPU's)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("chip_dist_study: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch import serving
    from repro_torch.core import build
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed import sharded_search as ss
    from repro_torch.kernels import _build, ops

    card = "cpu"
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        card = cs.gpu_name_power()
        _build.build_all(ops.LIBRARIES)
    print(f"[study] {card}; {torch.cuda.device_count()} card(s)", flush=True)
    cfg = cs.sift1m()
    x, queries = make_dataset(REGISTRY["sift1m"], seed=0, device=dev,
                              n=args.n)
    qn = queries[:cs.N_QUERIES if dev.type == "cuda" else 2000].cpu().numpy()
    batches = [qn[s:s + cs.SERVE_BATCH]
               for s in range(0, qn.shape[0], cs.SERVE_BATCH)]
    mesh = make_mesh(cs.DIST_MESH, cs.DIST_AXES, dev)
    t0 = time.perf_counter()
    arrays, _ = ss.build_sharded_arrays(
        x, mesh, build_cfg=build.BuildConfig(
            degree=cfg.degree, beam_width=cfg.l_build, seed=0,
            batch=cs.BUILD_BATCH if dev.type == "cuda" else 512),
        m_pq=cs.M_PQ, alpha=cs.DIST_ALPHA, seed=0)
    print(f"[study] {mesh.n_shards} shards of {x.shape[0] // mesh.n_shards} "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    budget = cfg.beam_budget()
    kw = dict(beam_width=cfg.l_search, max_hops=cfg.max_hops, k=cfg.k,
              query_chunk=cs.SERVE_BATCH)
    back = serving.DistributedBackend(mesh, arrays, beam_budget=budget,
                                      budget_buckets=cfg.budget_buckets, **kw)
    one_mesh = copy.copy(mesh)
    if dev.type == "cuda":
        one_mesh.streams = ((torch.cuda.Stream(dev, priority=-1),)
                            * mesh.n_shards)
    one = serving.DistributedBackend(one_mesh, arrays, beam_budget=budget,
                                     budget_buckets=cfg.budget_buckets, **kw)
    backs = {"streams": back, "one": one}
    if args.parent:
        par = load_parent(args.parent)
        pb = copy.copy(back)
        pb.arrays = dict(arrays)
        pb.step = par.make_distributed_search(
            mesh, budget_buckets=cfg.budget_buckets, beam_budget=budget,
            **kw)
        pb._probe_step = par.make_distributed_probe(
            mesh, budget_cfg=budget, max_hops=cfg.max_hops,
            query_chunk=cs.SERVE_BATCH, budget_buckets=cfg.budget_buckets)
        pb._continue_step = par.make_distributed_continue(
            mesh, budget_cfg=budget, k=cfg.k)
        backs["parent"] = pb
    engines = {name: {"staged": serving.SearchEngine(b, budget, k=cfg.k),
                      "monolithic": serving.SearchEngine(b, None, k=cfg.k)}
               for name, b in backs.items()}
    for e in engines.values():                    # warm-up
        for eng in e.values():
            eng.search(batches[0])
    want = None
    order = list(engines)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            rec = {"variant": name, "round": r}
            for shape, eng in engines[name].items():
                m, res = serve(eng, batches)
                got = [(x_.ids, x_.d2) for x_ in res]
                if want is None:
                    want = got
                elif not all(np.array_equal(a[0], b[0])
                             and np.array_equal(a[1], b[1])
                             for a, b in zip(got, want)):
                    raise AssertionError(f"{name} {shape}: results differ")
                rec[shape] = m
            rec["trace_staged"] = profile_batch(engines[name]["staged"],
                                                batches[0])
            print(json.dumps(rec), flush=True)
    print(f"[study] every variant returned the same ids and d2; {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
