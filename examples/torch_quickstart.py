"""Quickstart on the PyTorch port: build an MCGI index, search it, compare
against the paper's DiskANN baseline; the 60-second tour of
``repro_torch``'s public API, on the card by default.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
        [--n 4000]

On the card every walk is one launch of the ``beam_step`` kernel, and the
ground truth and the LID k-NN run on ``l2_distance`` + ``topk`` (the HNSW
and IVF-Flat baselines are ``repro_torch.core.hnsw`` / ``ivf``).
"""
import argparse
import time

from repro_torch import resolve_device
from repro_torch.core import (
    BuildConfig,
    beam_search_exact,
    brute_force_topk,
    build_mcgi,
    build_vamana,
    recall_at_k,
)
from repro_torch.data import make_dataset


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the base set to N points (default: all 4000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # 1. A dataset with heterogeneous manifold geometry (MCGI's target regime).
    x, queries = make_dataset("tiny-mixture", seed=args.seed, device=dev,
                              n=args.n)
    print(f"dataset: {x.shape[0]} points, D={x.shape[1]} on {dev}")
    _, gt_ids = brute_force_topk(queries, x, k=10)

    # 2. Build MCGI (Algorithm 1): LID calibration + adaptive-alpha refinement.
    cfg = BuildConfig(degree=32, beam_width=64, iters=2)
    t0 = time.time()
    index = build_mcgi(x, cfg, progress=print, device=dev)
    print(f"MCGI built in {time.time() - t0:.1f}s; "
          f"LID mu={float(index.mu):.2f} sigma={float(index.sigma):.2f}; "
          f"alpha in [{float(index.alpha.min()):.3f}, "
          f"{float(index.alpha.max()):.3f}]")

    # 3. Search (batched beam search) and evaluate.
    for L in (16, 32, 64):
        ids, _, stats = beam_search_exact(x, index.adj, queries, index.entry,
                                          beam_width=L, k=10)
        r = out[f"mcgi_L{L}"] = float(recall_at_k(ids, gt_ids))
        print(f"  L={L:3d}: recall@10={r:.4f} "
              f"io/query={float(stats.hops.float().mean()):.1f}")

    # 4. The DiskANN baseline is one call away (constant alpha).
    vam = build_vamana(x, alpha=1.2, cfg=cfg, device=dev)
    ids, _, stats_v = beam_search_exact(x, vam.adj, queries, vam.entry,
                                        beam_width=32, k=10)
    r = out["vamana_L32"] = float(recall_at_k(ids, gt_ids))
    print(f"vamana L=32: recall@10={r:.4f} "
          f"io/query={float(stats_v.hops.float().mean()):.1f}")

    return out


if __name__ == "__main__":
    main()
