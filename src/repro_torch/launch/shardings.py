"""The reference's sharding rules, kept as a record (port of
:mod:`repro.launch.shardings`).

Nothing in the port shards anything: one card holds every tensor.  This
module keeps what the reference would shard, so a reader (and the dry run)
can see how a cell spreads over the reference's 16 x 16 mesh.  One table of
(path regex -> spec template) per family; a spec is a plain tuple with one
entry per dimension: ``None`` (replicated), an axis name, or a tuple of axis
names (the reference's ``jax.sharding.PartitionSpec`` entries).

Leaves are named as the reference names them: an LM tree's per-layer list
reads as the reference's stacked ``layers/attn/wq`` (one leaf for every
layer, its rank one more; ``optimizer.reference_leaves``).
"""
from __future__ import annotations

import re

from repro_torch.training import optimizer as opt_mod

Spec = tuple

# ----------------------------------------------------------------- LM rules

_LM_RULES: list[tuple[str, Spec]] = [
    (r"embed$", ("model", "data")),
    (r"lm_head$", ("data", "model")),
    (r"ln_", ()),
    (r"(q_norm|k_norm|kv_norm)$", ()),
    (r"layers/attn/(wq|wk|wv)$", (None, "data", "model")),
    (r"layers/attn/(bq|bk|bv)$", (None, "model")),
    (r"layers/attn/wo$", (None, "model", "data")),
    (r"layers/attn/w_dkv$", (None, "data", None)),
    (r"layers/attn/(w_uk|w_uv)$", (None, None, "model")),
    (r"layers/moe/router$", (None, "data", None)),
    (r"layers/moe/(w_gate|w_up)$", (None, "model", "data", None)),
    (r"layers/moe/w_down$", (None, "model", None, "data")),
    (r"layers/moe/shared/(w_gate|w_up)$", (None, "data", "model")),
    (r"layers/moe/shared/w_down$", (None, "model", "data")),
    (r"layers/ffn/(w_gate|w_up)$", (None, "data", "model")),
    (r"layers/ffn/w_down$", (None, "model", "data")),
]

# ------------------------------------------------------------- recsys rules

_RECSYS_RULES: list[tuple[str, Spec]] = [
    (r"(table|items|first_order)$", (("data", "model"), None)),
    (r".*", ()),  # MLPs / norms / scalars replicated
]

_GNN_RULES: list[tuple[str, Spec]] = [(r".*", ())]

_FAMILY_RULES = {"lm": _LM_RULES, "recsys": _RECSYS_RULES, "gnn": _GNN_RULES}


def reference_shapes(tree) -> dict[str, tuple[int, ...]]:
    """{reference leaf name: its shape} of a tree in the port's layout (a
    stacked leaf's shape leads with the layer count)."""
    out = {}
    for name, ts, stacked in opt_mod.reference_leaves(tree):
        shape = tuple(ts[0].shape)
        out[name] = (len(ts),) + shape if stacked else shape
    return out


def spec_for(family: str, path: str, ndim: int) -> Spec:
    """The spec of the leaf named ``path`` of rank ``ndim``: the first
    matching template trimmed or extended to the rank."""
    for pat, spec in _FAMILY_RULES[family]:
        if re.search(pat, path):
            entries = list(spec)
            if len(entries) > ndim:
                # Drop leading Nones first (stacked-layer templates applied
                # to unstacked leaves), then trailing.
                while len(entries) > ndim and entries and entries[0] is None:
                    entries.pop(0)
                entries = entries[:ndim]
            while len(entries) < ndim:
                entries.append(None)
            return tuple(entries)
    return ()


def param_specs(family: str, params) -> dict[str, Spec]:
    """{reference leaf name: spec} of a parameter tree."""
    return {name: spec_for(family, name, len(shape))
            for name, shape in reference_shapes(params).items()}


def train_state_specs(family: str, state) -> dict:
    """Specs of a ``TrainState``: params, m and v share the parameter
    rules, ``step`` is replicated, error feedback follows the params."""
    p_spec = param_specs(family, state.params)
    return {"params": p_spec,
            "opt": {"m": dict(p_spec), "v": dict(p_spec), "step": ()},
            "error_feedback": (None if state.error_feedback is None
                               else dict(p_spec))}


def check_divisibility(shapes: dict[str, tuple[int, ...]],
                       specs: dict[str, Spec],
                       axis_sizes: dict[str, int]) -> list[str]:
    """The leaves whose sharded dims do not divide the mesh axes (they would
    pad on the reference's hardware), given ``{axis: size}``."""
    problems = []
    for name, shape in shapes.items():
        for dim, entry in enumerate(specs[name]):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            total = 1
            for a in axes:
                total *= axis_sizes[a]
            if shape[dim] % total != 0:
                problems.append(f"{name}: dim{dim}={shape[dim]} not "
                                f"divisible by {axes}={total}")
    return problems
