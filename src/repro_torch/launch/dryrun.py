"""The dry run: every (architecture x input shape) cell priced on the meta
device (port of :mod:`repro.launch.dryrun`).

For a cell, :func:`run_one` builds its arguments as meta tensors of the
reference's global shapes (:mod:`repro_torch.launch.cells`), runs its step
on them under :class:`~repro_torch.launch.hlo_analysis.CostMode` (kernels
answer through their shape functions, ``kernels.ops.shapes_only``) and
writes one JSON record: memory (argument, output, temp, donated and peak
bytes), FLOPs by dtype, bytes accessed and the roofline terms of one H100.
LM and recsys serve and train cells and every GAT cell run their step; an
MCGI serve cell walks under host control, so it is accounted for by its
shapes (``cost.accounting`` "shapes": its walk is not priced).  Nothing
here needs a card.

``--cards N`` prices an MCGI serve cell per card with its 256 shards in
contiguous blocks over N cards, as the reference's
``peak_per_device_bytes`` prices a device: each card holds its shards'
rows, entries and laws, the replicated codebook, queries and LUTs, one
query chunk's walk state for each of its shards (their walks overlap on
their streams, at most ``STREAMS_PER_POOL`` of them), and the first card
the gathered candidates and the merged result.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k \
      --batch 2                                 # the batch cut to 2
  python -m repro_torch.launch.dryrun --all     # every cell, a process each
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --table   # the records as markdown
  python -m repro_torch.launch.dryrun --arch mcgi-sift1b --shape serve \
      --cards 4                                 # per card, 256 shards on 4

The reference's ``--multipod`` (a 2 x 16 x 16 mesh), its collective bytes
and its loop-differential extrapolation have no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

from repro_torch.distributed.mesh import STREAMS_PER_POOL

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")


def _tensors(tree) -> list[torch.Tensor]:
    from repro_torch.training import optimizer as opt_mod

    return [t for _, t in opt_mod.flatten(tree)]


def _nbytes(tree) -> int:
    from repro_torch.launch import hlo_analysis as ha

    return sum(ha.tensor_bytes(t) for t in _tensors(tree))


def _storage_bytes(tensors, device) -> dict[int, int]:
    """{storage id: bytes} of the distinct storages on ``device``."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tensors if t.device == device}


def measure(cell) -> dict:
    """Run ``cell``'s step on its meta arguments under the cost mode:
    {memory, cost, kernels, seconds}."""
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.training.train_step import TrainState

    dev = ha.META
    args = _tensors(cell.arg_specs)
    each = [sum(ha.tensor_bytes(t) for t in _tensors(a))
            for a in cell.arg_specs]
    arg_bytes = sum(each)
    arg_store = _storage_bytes(args, dev)
    if cell.fn is None:                       # MCGI: shapes only, a card
        ex = cell.extra_specs
        per_card = -(-cell.n_shards // cell.cards)   # the first card's
        each = [b // cell.n_shards * per_card if i in cell.sharded_args
                else b for i, b in enumerate(each)]
        walks = min(per_card, STREAMS_PER_POOL)
        out = _nbytes(ex["out"])
        temp = (_nbytes(ex["ctxs"]) + walks * _nbytes(ex["walk"])
                + _nbytes(ex["candidates"]))
        memory = {"argument_bytes": sum(each), "argument_bytes_each": each,
                  "output_bytes": out, "temp_bytes": temp,
                  "alias_bytes": 0,
                  "peak_per_device_bytes": sum(each) + temp + out}
        cost = {"flops_per_device": 0, "flops_by_dtype": {},
                "bytes_accessed_per_device": 0, "accounting": "shapes"}
        return {"memory": memory, "cost": cost, "kernels": {}, "seconds": 0.0}

    ops.reset_shape_calls()
    train = isinstance(cell.arg_specs[0], TrainState)   # autograd records
    t0 = time.perf_counter()
    with torch.set_grad_enabled(train), ops.shapes_only(), \
            ha.CostMode(live=args) as mode:
        result = cell.fn(*cell.arg_specs)
        outs = _tensors(result)
        peak = mode.peak_bytes
    seconds = time.perf_counter() - t0
    out_store = _storage_bytes(outs, dev)
    alias = sum(n for k, n in out_store.items() if k in arg_store)
    out_bytes = sum(out_store.values())
    in_dev = sum(arg_store.values())
    memory = {"argument_bytes": arg_bytes, "argument_bytes_each": each,
              "output_bytes": out_bytes,
              "temp_bytes": peak - in_dev - (out_bytes - alias),
              "alias_bytes": alias, "peak_per_device_bytes": peak}
    cost = {"flops_per_device": mode.flops,
            "flops_by_dtype": dict(mode.flops_by_dtype),
            "bytes_accessed_per_device": mode.bytes_accessed,
            "bytes_accessed_is": "upper bound: eager, unfused, each aten "
                                 "op's inputs read and outputs written once",
            "accounting": "traced"}
    return {"memory": memory, "cost": cost, "kernels": ops.shape_calls(),
            "seconds": seconds}


def record_path(out_dir: pathlib.Path, arch: str, shape: str,
                smoke: bool = False, batch: int | None = None,
                cards: int = 1) -> pathlib.Path:
    tag = ("-smoke" if smoke else "") + (f"-b{batch}" if batch else "")
    return out_dir / f"{arch}__{shape}{tag}__card{cards}.json"


def run_one(arch: str, shape: str, out_dir: pathlib.Path,
            smoke: bool = False, batch: int | None = None,
            cards: int = 1) -> dict:
    from repro_torch.launch import cells as cells_mod
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.perf_counter()
    mesh = make_production_mesh(device="meta", cards=cards)
    cell = cells_mod.build_cell(arch, shape, mesh, smoke=smoke, batch=batch)
    if cards > 1 and cell.fn is not None:
        raise ValueError(f"--cards prices the MCGI serve cells; {arch} runs "
                         f"on one card")
    t_build = time.perf_counter() - t0
    m = measure(cell)
    cost = m["cost"]
    terms = ha.roofline_terms(flops_by_dtype=cost["flops_by_dtype"],
                              bytes_accessed=cost["bytes_accessed_per_device"])
    peak = m["memory"]["peak_per_device_bytes"]
    record = {
        "arch": arch,
        "shape": shape,
        "smoke": smoke,
        "batch": batch,
        "mesh": list(mesh.shape.values()),
        "mesh_axes": list(mesh.axis_names),
        "n_chips": cards,
        "note": cell.note,
        "timings_s": {"build": t_build, "run": m["seconds"]},
        "memory": m["memory"],
        "fits_80gb": peak <= ha.HBM_BYTES,
        "cost": cost,
        "kernels_unpriced": m["kernels"],
        "roofline": terms,
        "torch_version": torch.__version__,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    record_path(out_dir, arch, shape, smoke, batch, cards).write_text(
        json.dumps(record, indent=2))
    print(f"[dryrun] {arch}/{shape} OK  "
          f"peak={peak / 1e9:.3f} GB{' a card' if cards > 1 else ''} "
          f"flops={cost['flops_per_device']:.3e} "
          f"bytes={cost['bytes_accessed_per_device']:.3e} "
          f"dominant={terms['dominant']} "
          f"bound={terms['bound_s'] * 1e3:.3f} ms "
          f"[{cost['accounting']}] run={m['seconds']:.1f}s", flush=True)
    return record


def run_all(out_dir: pathlib.Path, only_missing: bool) -> int:
    """Every cell in a process of its own (one failure cannot take the
    sweep down)."""
    from repro_torch.launch import cells as cells_mod

    failures = []
    t0 = time.perf_counter()
    for arch, shape in cells_mod.all_cells():
        if only_missing and record_path(out_dir, arch, shape).exists():
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", str(out_dir)]
        print(f"[dryrun] >>> {arch}/{shape}", flush=True)
        if subprocess.run(cmd).returncode != 0:
            failures.append((arch, shape))
            print(f"[dryrun] FAILED {arch}/{shape}", flush=True)
    print(f"[dryrun] sweep took {time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}")
        return 1
    print("[dryrun] all cells passed")
    return 0


def table(out_dir: pathlib.Path, cards: int = 1) -> list[str]:
    """One markdown row a cell from the full-config records in
    ``out_dir`` at ``cards`` cards, in ``all_cells`` order (a missing
    record says so)."""
    from repro_torch.launch import cells as cells_mod

    rows = ["| cell | peak GB | fits 80 GB | FLOPs by dtype | compute ms | "
            "dominant | bound ms | kernels not priced |",
            "|---|---|---|---|---|---|---|---|"]
    for arch, shape in cells_mod.all_cells():
        path = record_path(out_dir, arch, shape, cards=cards)
        if not path.exists():
            rows.append(f"| {arch} / {shape} | no record | | | | | | |")
            continue
        r = json.loads(path.read_text())
        cost, terms = r["cost"], r["roofline"]
        peak = r["memory"]["peak_per_device_bytes"]
        if cost["accounting"] == "shapes":
            flops = compute = dominant = bound = "not priced (walk)"
        else:
            flops = ", ".join(f"{k} {v:.3e}"
                              for k, v in cost["flops_by_dtype"].items())
            compute = f"{terms['compute_s'] * 1e3:.3f}"
            dominant = terms["dominant"].replace("_s", "")
            bound = f"{terms['bound_s'] * 1e3:.3f}"
        kernels = ", ".join(f"{k} x{v}"
                            for k, v in r["kernels_unpriced"].items())
        rows.append(f"| {arch} / {shape} | {peak / 1e9:.3f} | "
                    f"{'yes' if r['fits_80gb'] else '**no**'} | {flops} | "
                    f"{compute} | {dominant} | {bound} | {kernels or '-'} |")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--batch", type=int,
                    help="replace the cell's batch (LM and recsys cells)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a table")
    ap.add_argument("--cards", type=int, default=1,
                    help="price an MCGI serve cell per card, its 256 shards "
                         "over N cards")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    if args.list:
        from repro_torch.configs import base as cfg_base

        for arch_id, spec in cfg_base.all_archs().items():
            for cell in spec.shapes:
                print(f"{arch_id:24s} {cell.name:16s} {cell.kind}")
        return 0
    if args.table:
        print("\n".join(table(out_dir, args.cards)))
        return 0
    if args.all:
        return run_all(out_dir, args.only_missing)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --list)")
    run_one(args.arch, args.shape, out_dir, batch=args.batch,
            cards=args.cards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
