#!/usr/bin/env python3
"""Is the merged generation's lower recall in ``chip_smoke.py``'s [live]
the rows' doing or the merge's?

    python3 chip_live_probe.py [--n 1000000] [--seed 0]
    python3 chip_live_probe.py --device cpu --n 3000 --inserts 300 \
        --deletes 300                       # a rehearsal on the CPU

Runs [live]'s write path as ``chip_smoke.py`` does at phase 3's data (the
sift1m-shaped rows and 10,000 queries from the seed): a ``LiveIndex`` over
the first N - 10,000 rows, the last 10,000 rows inserted, 10,000 base ids
deleted (drawn as [live] draws them), then one merge.  [live] merges
beside traffic, which shares the host but not the build's inputs; here the
merge runs alone.  The stream is served by the base index (against the
base rows' ground truth) and at the merge boundary.  Then a
fresh ``LiveIndex`` is built over the merged generation's live rows, in
the same order and with the same config, and serves the same stream
against the same ground truth.  Each index is also served under the
other's budget law, which separates the graph from the law.  Prints one
JSON line: the recalls, the laws, the build seconds, whether the two
graphs and the two PQ tiers are equal.  Runs on one CUDA card (about 6
minutes at 1M rows) unless ``--device cpu`` is asked for.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inserts", type=int)
    ap.add_argument("--deletes", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import build
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.index.delta import LiveIndex
    from repro_torch.kernels import _build, ops

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("chip_live_probe.py: no CUDA card (--device cpu runs on "
                  "the CPU)", file=sys.stderr)
            return 2
        card = cs.gpu_name_power()
        _build.build_all(ops.LIBRARIES)
    else:
        card = "the CPU"
    cfg, seed = cs.sift1m(), args.seed
    x, queries = make_dataset(REGISTRY["sift1m"], seed=seed, device=dev,
                              n=args.n)
    qn = queries[:cs.N_QUERIES].cpu().numpy()
    batches = [qn[s:s + cs.SERVE_BATCH]
               for s in range(0, qn.shape[0], cs.SERVE_BATCH)]
    n = x.shape[0]
    inserts = args.inserts or cs.LIVE_INSERTS
    deletes = args.deletes or cs.LIVE_DELETES
    n_base = n - inserts
    rng = np.random.default_rng(seed + 19)      # [live]'s draws, in order
    calib = qn[rng.choice(qn.shape[0], min(cs.CALIB_SAMPLE, qn.shape[0]),
                          replace=False)]
    bcfg = build.BuildConfig(degree=cfg.degree, beam_width=cfg.l_build,
                             alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
                             batch=cs.BUILD_BATCH, seed=seed)
    kw = dict(budget_cfg=cfg.beam_budget(), k=cfg.k,
              beam_width=cfg.l_search, max_hops=cfg.max_hops, m_pq=cs.M_PQ,
              nodes_per_block=4, merge_threshold=10 ** 12, calib=calib,
              recall_target=cs.TIERED_TARGET, device=dev)
    starts = np.cumsum([0] + [b.shape[0] for b in batches[:-1]])

    def split(gt):
        return [gt[s:s + b.shape[0]] for s, b in zip(starts, batches)]

    tmp = tempfile.mkdtemp(prefix="mcgi-live-probe-")
    out = {"n": n, "seed": seed}
    try:
        t0 = time.perf_counter()
        live = LiveIndex(x[:n_base], bcfg, store_dir=os.path.join(tmp, "m"),
                         **kw)
        out["base_build_s"] = time.perf_counter() - t0
        gt0 = cs.live_gt(x, np.arange(n_base), qn, cfg.k)
        live.search(qn[:64])                                # warm-up
        base = cs.live_serve("base", live, batches, split(gt0), None, card)
        per_call = inserts // cs.LIVE_INSERT_CALLS
        for c in range(cs.LIVE_INSERT_CALLS):
            live.insert(x[n_base + c * per_call:n_base + (c + 1) * per_call],
                        auto_merge=False)
        gone = np.sort(rng.choice(n_base, deletes, replace=False))
        live.delete(gone)
        alive = np.setdiff1d(np.arange(n), gone)
        gts = split(cs.live_gt(x, alive, qn, cfg.k))
        t0 = time.perf_counter()
        live.merge()
        out["merge_s"] = time.perf_counter() - t0
        out["recalibrated"] = bool(live.lineage.get("recalibrations"))
        live.search(qn[:64])                                # warm-up
        merged = cs.live_serve("merged generation", live, batches, gts, gone,
                               card)

        t0 = time.perf_counter()
        fresh = LiveIndex(x[torch.as_tensor(alive, device=dev)], bcfg,
                          store_dir=os.path.join(tmp, "f"), **kw)
        out["fresh_build_s"] = time.perf_counter() - t0
        # The fresh index's external ids are positions in ``alive``.
        pos = [np.searchsorted(alive, g) for g in gts]
        fresh.search(qn[:64])
        fresh_m = cs.live_serve("fresh index over the live rows", fresh,
                                batches, pos, None, card)
        laws = {"merged": live.engine.budget_cfg,
                "fresh": fresh.engine.budget_cfg}
        fresh.engine.budget_cfg = laws["merged"]
        fresh_mlaw = cs.live_serve("fresh index, the merged law", fresh,
                                   batches, pos, None, card)
        fresh.engine.budget_cfg = laws["fresh"]
        live.engine.budget_cfg = laws["fresh"]
        merged_flaw = cs.live_serve("merged generation, the fresh law", live,
                                    batches, gts, gone, card)
        live.engine.budget_cfg = laws["merged"]
        g_m = live._state.delta._arr.adj
        g_f = fresh._state.delta._arr.adj
        i_m, i_f = live.engine.backend.index, fresh.engine.backend.index
        out.update(
            recall_base=base["recall"], recall_merged=merged["recall"],
            recall_fresh=fresh_m["recall"],
            recall_fresh_merged_law=fresh_mlaw["recall"],
            recall_merged_fresh_law=merged_flaw["recall"],
            law_merged=[laws["merged"].lam, laws["merged"].l_min],
            law_fresh=[laws["fresh"].lam, laws["fresh"].l_min],
            graphs_equal=bool(g_m.shape == g_f.shape
                              and torch.equal(g_m, g_f)),
            codes_equal=bool(torch.equal(i_m.codes, i_f.codes)),
            centroids_max_abs_diff=float(
                (i_m.codebook.centroids - i_f.codebook.centroids).abs()
                .max()),
            card=card)
        live.close()
        fresh.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
