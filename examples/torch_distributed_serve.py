"""Distributed MCGI serving on the PyTorch port through the serving engine
(``repro_torch.serving.SearchEngine`` over a ``DistributedBackend``): shard
the index over a (2, 4) mesh, fan out queries, merge the global top-k, then
drop a shard and watch the hedged merge degrade gracefully.

The mesh is single-controller and spans every visible card (the CPU with
``--device cpu``), the shards in contiguous blocks: each shard's rows stay
on its own card, and its walk is one ``beam_step`` launch on its own
stream there, so the shards' walks overlap; the per-shard candidates are
gathered to the first card for the hedged merge.  No multi-device flags
are needed.  With a budget law on both the backend and
the engine the step runs *staged* (probe checkpointed at the horizon,
host bucketing, budget-bucketed continues, the hedged merge), bit-identical
to the monolithic one-program step.  The example ends with one (lam, l_min)
law fitted per shard.

    PYTHONPATH=src python examples/torch_distributed_serve.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device, serving
from repro_torch.core import BuildConfig, brute_force_topk, calibrate, recall_at_k
from repro_torch.core.search import AdaptiveBeamBudget
from repro_torch.data import make_dataset
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharded_search as ss


def _recall(ids, gt_ids) -> float:
    return float(recall_at_k(torch.as_tensor(ids), gt_ids.cpu()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the base set to N points (default: all 4000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    mesh = make_mesh((2, 4), ("data", "model"),
                     None if args.device == "cuda" else dev)
    n_shards = mesh.n_shards
    x, queries = make_dataset("tiny-mixture", seed=args.seed, device=dev,
                              n=args.n)
    queries = queries[:64].cpu().numpy()

    cfg = BuildConfig(degree=16, beam_width=32, iters=1, batch=256,
                      max_hops=64)
    arrays, per = ss.build_sharded_arrays(x, mesh, build_cfg=cfg, m_pq=8,
                                          seed=args.seed)
    x = x[:per * n_shards]
    print(f"[dist] {per * n_shards} points over {n_shards} shards "
          f"({per}/shard): {mesh.describe()}")
    _, gt_ids = brute_force_topk(torch.as_tensor(queries, device=dev), x,
                                 k=10)

    backend = serving.DistributedBackend(
        mesh, arrays, beam_width=32, max_hops=64, k=10, query_chunk=16)
    engine = serving.SearchEngine(backend, k=10)

    # Stream two chunks through the pipelined executor: batch 1 is
    # dispatched before batch 0 is collected.
    res = list(engine.search_batches([queries[:32], queries[32:]]))
    r = out["all_shards"] = _recall(np.concatenate([b.ids for b in res]),
                                    gt_ids)
    print(f"[dist] all shards up:   recall@10={r:.4f} "
          f"(2-batch double-buffered stream)")

    # Straggler / fault injection: shard 5 misses its deadline, a runtime
    # mask on the live engine.
    ok = np.ones((n_shards,), bool)
    ok[5] = False
    backend.set_shard_ok(ok)
    res = engine.search(queries)
    r = out["shard5_dropped"] = _recall(res.ids, gt_ids)
    print(f"[dist] shard 5 dropped: recall@10={r:.4f} "
          f"(graceful: lost ~1/{n_shards} of the data, no stall)")
    assert (res.extras["shard_ids"] != 5).all()
    backend.set_shard_ok(np.ones((n_shards,), bool))

    # Adaptive per-query budgets on every shard, served staged: the engine
    # holds the same budget law as the backend, so probe / host-bucket /
    # continue are separate steps and search_batches overlaps batch i+1's
    # probe with batch i's bucketing and continues.  The LID center is
    # pinned: batch-mean centring would make budgets depend on which
    # queries share a probe chunk.
    budget = AdaptiveBeamBudget(l_min=8, l_max=32, lam=0.35, center=8.0)
    staged_backend = serving.DistributedBackend(
        mesh, arrays, beam_width=32, max_hops=64, k=10, query_chunk=16,
        beam_budget=budget, budget_buckets=4)
    adaptive = serving.SearchEngine(staged_backend, budget, k=10,
                                    num_buckets="auto")
    res = list(adaptive.search_batches([queries[:16], queries[16:40],
                                        queries[40:]]))
    r = out["staged"] = _recall(np.concatenate([b.ids for b in res]), gt_ids)
    io = float(np.mean(np.concatenate([np.asarray(b.stats.hops)
                                       for b in res])))
    print(f"[dist] staged adaptive:  recall@10={r:.4f} io/query={io:.0f} "
          f"(probe checkpointed at the horizon, budget-bucketed continues, "
          f"pipelined stream)")

    # The staged split is result-transparent: the monolithic one-program
    # step returns the same global top-k, bit for bit.
    mono = serving.SearchEngine(serving.DistributedBackend(
        mesh, arrays, beam_width=32, max_hops=64, k=10, query_chunk=16,
        beam_budget=budget, budget_buckets=4), k=10)
    ref = mono.search(queries)
    assert (np.concatenate([b.d2 for b in res]) == ref.d2).all()
    print("[dist] staged == monolithic step (bit-identical d2)")

    # Per-shard budget laws: fit (lam, l_min) on each shard's own held-out
    # sample and serve them as runtime tensors.
    fit = calibrate.calibrate_budget_law_per_shard(
        calibrate.shard_exact_recall_evals(
            arrays["vectors"], arrays["adj"], arrays["entries"], queries,
            n_shards, k=10, sample=32, mesh=mesh),
        budget, recall_target=0.9, n_shards=n_shards, max_iters=3)
    lam_arr, l_min_arr = fit.law_arrays()
    # hop_factor is global in the step: serve the largest fitted one.
    budget_srv = fit.serving_budget(budget)
    print(f"[dist] per-shard laws:   lam={np.round(lam_arr, 3).tolist()} "
          f"l_min={l_min_arr.tolist()} hop_factor={budget_srv.hop_factor}")
    per_shard = serving.SearchEngine(
        serving.DistributedBackend(
            mesh, arrays, beam_width=32, max_hops=64, k=10, query_chunk=16,
            beam_budget=budget_srv, budget_buckets=4,
            shard_laws=(lam_arr, l_min_arr)),
        budget_srv, k=10, num_buckets="auto")
    res = per_shard.search(queries)
    r = out["per_shard"] = _recall(res.ids, gt_ids)
    io = float(np.mean(np.asarray(res.stats.hops)))
    print(f"[dist] per-shard serve:  recall@10={r:.4f} io/query={io:.0f} "
          f"(each shard on its own calibrated budget law)")
    return out


if __name__ == "__main__":
    main()
