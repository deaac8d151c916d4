"""The cells: (arch spec, shape cell, mesh) -> a step and its arguments
as meta tensors (port of :mod:`repro.launch.cells`).

A *cell* is one (architecture x input shape) entry of the reference's
assignment.  :func:`build_cell` returns a :class:`Cell` holding

* ``fn``        the step (train / prefill / decode / serve / retrieval), or
                ``None`` for an MCGI serve cell, which walks under host
                control (its hop counter is read once a batch) and so is
                accounted for by its shapes, not run;
* ``arg_specs`` the step's arguments as ``meta`` tensors of the reference's
                global shapes and dtypes: parameters from the port's own
                ``init_*`` (float32, as the reference initialises them),
                train state from ``init_train_state``, batches, caches, the
                sharded index;
* ``donate``    the arguments the step updates in place (the reference's
                donated argnums).

The reference's ``layer_unroll`` / ``layer_loop_length`` /
``small_divisor`` price XLA's layer loop; eager layers need none of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_step as ts_mod

META = torch.device("meta")
# The optimizer settings of the reference's cells: the recsys train cells,
# the GAT cells (AdamWConfig's defaults otherwise) and the LM schedule.
RECSYS_OPT = {"lr": 1e-3, "weight_decay": 0.0}
GAT_OPT = {"lr": 5e-3, "weight_decay": 5e-4}
RECSYS_SLATE = 100            # MIND / BERT4Rec serve: candidates a query
BERT4REC_MASKS = 20           # cloze positions a sequence


def lm_schedule(arch_id: str) -> str:
    """The LM train cells' schedule: WSD for minicpm, cosine otherwise."""
    return "wsd" if "minicpm" in arch_id else "cosine"


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable | None
    arg_specs: tuple
    donate: tuple[int, ...] = ()
    note: str = ""
    config: Any = None            # the model / dataset config it was built at
    # MCGI: the walk's state and outputs beside the index (shapes only),
    # the arguments laid over the shards (the rest replicated), the shards
    # and the cards they spread over in contiguous blocks.
    extra_specs: dict[str, Any] = dataclasses.field(default_factory=dict)
    sharded_args: tuple[int, ...] = ()
    n_shards: int = 1
    cards: int = 1


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ------------------------------------------------------------------ LM cells

def _lm_cell(spec: cfg_base.ArchSpec, cell: cfg_base.ShapeCell, mesh,
             smoke: bool = False) -> Cell:
    cfg: tfm.TransformerConfig = spec.smoke_config if smoke else spec.config
    b, s = cell.meta["batch"], cell.meta["seq"]
    params = tfm.init_lm(cfg, None, device=META, dtype=torch.float32)

    if cell.kind == cfg_base.TRAIN:
        # Float32 moments on meta, the step counter on the host, as on the
        # card.
        step = ts_mod.make_train_step(
            lambda p, batch: tfm.lm_loss(cfg, p, batch),
            opt_mod.AdamWConfig(schedule=lm_schedule(spec.arch_id)))
        data = {"tokens": _meta((b, s), torch.int32),
                "labels": _meta((b, s), torch.int32)}
        return Cell(spec.arch_id, cell.name, step,
                    (ts_mod.init_train_state(params), data), donate=(0,),
                    config=cfg)

    if cell.kind == cfg_base.PREFILL:
        fn = lambda p, tokens: tfm.prefill(cfg, p, tokens)  # noqa: E731
        return Cell(spec.arch_id, cell.name, fn,
                    (params, _meta((b, s), torch.int32)), config=cfg)

    if cell.kind == cfg_base.DECODE:
        fn = lambda p, cache, tokens, kv_len: tfm.decode_step(  # noqa: E731
            cfg, p, cache, tokens, kv_len)
        cache = tfm.init_cache(cfg, b, s, dtype=torch.bfloat16, device=META)
        return Cell(spec.arch_id, cell.name, fn,
                    (params, cache, _meta((b, 1), torch.int32),
                     _meta((b,), torch.int32)),
                    donate=(1,), note=cell.note, config=cfg)

    raise ValueError(cell.kind)


# ----------------------------------------------------------------- GNN cells

def _gnn_cell(spec: cfg_base.ArchSpec, cell: cfg_base.ShapeCell, mesh,
              smoke: bool = False) -> Cell:
    arch_cfg = spec.smoke_config if smoke else spec.config
    meta = cell.meta
    pad = max(mesh_mod.n_devices(mesh), 512)
    graph = meta["level"] == "graph"
    mult = meta["batch_graphs"] if graph else 1
    n_nodes = cfg_base.pad_to(meta["n_nodes"] * mult, pad)
    n_edges = cfg_base.pad_to(meta["n_edges"] * mult, pad)
    gat_cfg = arch_cfg.for_regime(meta["d_feat"], meta["n_classes"])

    loss = gnn_mod.gat_graph_loss if graph else gnn_mod.gat_loss
    step = ts_mod.make_train_step(lambda p, b: loss(gat_cfg, p, b),
                                  opt_mod.AdamWConfig(**GAT_OPT))
    state = ts_mod.init_train_state(
        gnn_mod.gat_init(None, gat_cfg, device=META))
    data = {"features": _meta((n_nodes, meta["d_feat"]), torch.float32),
            "edge_index": _meta((2, n_edges), torch.int32)}
    if graph:
        data["graph_ids"] = _meta((n_nodes,), torch.int32)
        data["labels"] = _meta((meta["batch_graphs"],), torch.int32)
    else:
        data["labels"] = _meta((n_nodes,), torch.int32)
        data["mask"] = _meta((n_nodes,), torch.bool)
    return Cell(spec.arch_id, cell.name, step, (state, data), donate=(0,),
                note=cell.note, config=gat_cfg)


# -------------------------------------------------------------- recsys cells

def _recsys_forward_fns(arch_id: str, cfg) -> dict[str, Callable]:
    r = recsys_mod
    if arch_id == "dlrm-mlperf":
        return {
            "loss": lambda p, b: r.dlrm_loss(cfg, p, b),
            "serve": lambda p, b: r.dlrm_forward(cfg, p, b["dense"],
                                                 b["sparse"]),
            "retrieval": lambda p, b: r.dlrm_retrieval(cfg, p, b),
        }
    if arch_id == "deepfm":
        return {
            "loss": lambda p, b: r.deepfm_loss(cfg, p, b),
            "serve": lambda p, b: r.deepfm_forward(cfg, p, b["sparse"]),
            "retrieval": lambda p, b: r.deepfm_retrieval(cfg, p, b),
        }
    if arch_id == "mind":
        return {
            "loss": lambda p, b: r.mind_loss(cfg, p, b),
            "serve": lambda p, b: r.mind_retrieval(cfg, p, b),
            "retrieval": lambda p, b: r.mind_retrieval(cfg, p, b),
        }
    if arch_id == "bert4rec":
        return {
            "loss": lambda p, b: r.bert4rec_loss(cfg, p, b),
            "serve": lambda p, b: r.bert4rec_retrieval(cfg, p, b),
            "retrieval": lambda p, b: r.bert4rec_retrieval(cfg, p, b),
        }
    raise KeyError(arch_id)


def _recsys_batch_specs(arch_id: str, cfg, mesh, kind: str, meta) -> dict:
    b = meta.get("batch", 1)
    i32 = torch.int32
    if arch_id == "dlrm-mlperf":
        specs = {"dense": _meta((b, cfg.n_dense), torch.float32),
                 "sparse": _meta((b, cfg.n_sparse), i32)}
    elif arch_id == "deepfm":
        specs = {"sparse": _meta((b, cfg.n_fields), i32)}
    elif arch_id == "mind":
        specs = {"hist": _meta((b, cfg.hist_len), i32),
                 "hist_mask": _meta((b, cfg.hist_len), torch.bool)}
    elif arch_id == "bert4rec":
        specs = {"seq": _meta((b, cfg.seq_len), i32),
                 "seq_mask": _meta((b, cfg.seq_len), torch.bool)}
    else:
        raise KeyError(arch_id)

    if kind == cfg_base.TRAIN:
        if arch_id in ("dlrm-mlperf", "deepfm"):
            specs["labels"] = _meta((b,), torch.float32)
        elif arch_id == "mind":
            specs["target"] = _meta((b,), i32)
        else:
            specs["mlm_positions"] = _meta((b, BERT4REC_MASKS), i32)
            specs["mlm_labels"] = _meta((b, BERT4REC_MASKS), i32)
    if kind == cfg_base.RETRIEVAL:
        c = cfg_base.pad_to(meta["n_candidates"],
                            max(mesh_mod.n_devices(mesh), 512))
        specs["candidates"] = _meta((c,), i32)
    if kind == cfg_base.SERVE and arch_id in ("mind", "bert4rec"):
        # Online scoring against a served candidate slate.
        specs["candidates"] = _meta((RECSYS_SLATE,), i32)
    return specs


_RECSYS_INIT = {"dlrm-mlperf": recsys_mod.dlrm_init,
                "deepfm": recsys_mod.deepfm_init,
                "mind": recsys_mod.mind_init,
                "bert4rec": recsys_mod.bert4rec_init}


def _recsys_cell(spec: cfg_base.ArchSpec, cell: cfg_base.ShapeCell, mesh,
                 smoke: bool = False) -> Cell:
    cfg = spec.smoke_config if smoke else spec.config
    fns = _recsys_forward_fns(spec.arch_id, cfg)
    params = _RECSYS_INIT[spec.arch_id](None, cfg, device=META)
    data = _recsys_batch_specs(spec.arch_id, cfg, mesh, cell.kind, cell.meta)

    if cell.kind == cfg_base.TRAIN:
        step = ts_mod.make_train_step(fns["loss"],
                                      opt_mod.AdamWConfig(**RECSYS_OPT))
        return Cell(spec.arch_id, cell.name, step,
                    (ts_mod.init_train_state(params), data), donate=(0,),
                    config=cfg)

    fn = fns["serve" if cell.kind == cfg_base.SERVE else "retrieval"]
    return Cell(spec.arch_id, cell.name, fn, (params, data), config=cfg)


# ---------------------------------------------------------------- MCGI cells

def _mcgi_cell(spec: cfg_base.ArchSpec, cell: cfg_base.ShapeCell, mesh,
               smoke: bool = False) -> Cell:
    """The deployed engine's arguments (the sharded index with per-shard
    budget laws) and, beside them, what its walk holds: the per-shard LUTs
    of every query, one query chunk's walk state on one shard, and the
    per-shard candidates the hedged merge takes."""
    from repro_torch.distributed import sharded_search as ss

    cfg = spec.smoke_config if smoke else spec.config
    dtype = torch.uint8 if cfg.data_dtype == "uint8" else torch.float32
    # PQ subspaces need d % m == 0: pad the vector dim (T2I: 200 -> 208).
    d_pad = cfg_base.pad_to(cfg.d, cfg.m_pq) if cfg.m_pq else cfg.d
    nq = cfg.queries if smoke else cell.meta["queries"]
    specs = ss.sharded_index_specs(
        mesh, n=cfg.n, d=d_pad, degree=cfg.degree, m_pq=cfg.m_pq,
        n_queries=nq, data_dtype=dtype, per_shard_laws=True)
    args = (specs.adj, specs.codes, specs.vectors, specs.centroids,
            specs.queries, specs.shard_ok, specs.entries, specs.shard_lam,
            specs.shard_l_min)
    n_shards, k = mesh.n_shards, cell.meta["k"]
    per = specs.adj.shape[0] // n_shards
    chunk = min(128, cfg.queries)
    width = cfg.l_search
    i32, f32 = torch.int32, torch.float32
    if cfg.m_pq:
        m = specs.codes.shape[1]
        ctxs = _meta((nq, m, 256), f32)           # ADC LUTs of every query
    else:
        ctxs = _meta((nq, d_pad), f32)            # the raw queries
    extra = {
        "ctxs": ctxs,
        "walk": {"beam_ids": _meta((chunk, width), i32),
                 "beam_d": _meta((chunk, width), f32),
                 "beam_exp": _meta((chunk, width), torch.bool),
                 "visited": _meta((chunk, (per + 31) // 32), i32),
                 "hops": _meta((chunk,), i32), "evals": _meta((chunk,), i32),
                 "budgets": _meta((chunk,), i32),
                 "hop_limits": _meta((chunk,), i32)},
        "candidates": {"d2": _meta((n_shards, nq, k), f32),
                       "ids": _meta((n_shards, nq, k), i32)},
        "out": {"d2": _meta((nq, k), f32), "shard_id": _meta((nq, k), i32),
                "local_id": _meta((nq, k), i32)},
    }
    return Cell(spec.arch_id, cell.name, None, args, config=cfg,
                extra_specs=extra, sharded_args=(0, 1, 2, 5, 6, 7, 8),
                n_shards=n_shards, cards=mesh_mod.n_devices(mesh),
                note=("walks under host control; accounted for by shapes "
                      f"(kernel beam_step.{'pq' if cfg.m_pq else 'exact'})"))


_FAMILY_CELLS = {
    "lm": _lm_cell,
    "gnn": _gnn_cell,
    "recsys": _recsys_cell,
    "mcgi": _mcgi_cell,
}


def build_cell(arch_id: str, shape_name: str, mesh, smoke: bool = False,
               batch: int | None = None) -> Cell:
    """The cell at the reference's shapes; ``batch`` (LM and recsys cells)
    replaces the cell's batch, as a cut to fit one card would."""
    spec = cfg_base.get(arch_id)
    cell = spec.cell(shape_name)
    if batch is not None:
        if "batch" not in cell.meta:
            raise ValueError(f"{arch_id}/{shape_name} has no batch to set")
        cell = dataclasses.replace(cell, meta={**cell.meta, "batch": batch})
    return _FAMILY_CELLS[spec.family](spec, cell, mesh, smoke=smoke)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair in the assignment (MCGI serve cells too)."""
    return [(arch_id, cell.name)
            for arch_id, spec in cfg_base.all_archs().items()
            for cell in spec.shapes]


# ------------------------------------------------- the reference's leaf names

def _tree_leaves(prefix: str, tree) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of a tree as the reference names its leaves: an LM
    parameter tree's layer list as its stacks (stacked parts joined)."""
    if isinstance(tree, ts_mod.TrainState):
        out = _tree_leaves(f"{prefix}params/", tree.params)
        for part in ("m", "v"):
            out += _tree_leaves(f"{prefix}opt/{part}/", tree.opt[part])
        out.append((f"{prefix}opt/step", tree.opt["step"]))
        if tree.error_feedback is not None:
            out += _tree_leaves(f"{prefix}error_feedback/",
                                tree.error_feedback)
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("/"), tree)]
    if opt_mod.stacks_layers(tree):
        return [(prefix + name,
                 torch.stack(ts) if stacked else ts[0])
                for name, ts, stacked in opt_mod.reference_leaves(tree)]
    return [(prefix + "/".join(str(p) for p in path), t)
            for path, t in opt_mod.flatten(tree)]


def _cache_leaves(prefix: str, cache: dict, cfg) -> list:
    """The reference's cache: one stack, or {"dense", "scanned"} stacks
    for an MoE net with a dense prefix."""
    kd = cfg.first_k_dense if cfg.moe is not None else 0
    if not kd:
        return [(prefix + name, t) for name, t in cache.items()]
    return [(f"{prefix}{group}/{name}", part)
            for name, t in cache.items()
            for group, part in (("dense", t[:kd]), ("scanned", t[kd:]))]


def arg_leaves(cell: Cell) -> list[tuple[str, torch.Tensor]]:
    """Every argument leaf of ``cell`` as (reference name, meta tensor);
    the name leads with the argument's index."""
    spec = cfg_base.get(cell.arch_id)
    out = []
    for i, arg in enumerate(cell.arg_specs):
        if (spec.family == "lm" and spec.cell(cell.shape_name).kind
                == cfg_base.DECODE and i == 1):
            out += _cache_leaves(f"{i}/", arg, cell.config)
        else:
            out += _tree_leaves(f"{i}/", arg)
    return out


def arg_bytes(cell: Cell) -> int:
    return sum(t.numel() * t.element_size() for _, t in arg_leaves(cell))
