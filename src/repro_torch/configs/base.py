"""Config-system core: architecture specs, shape cells, the registry (the
port's copy of :mod:`repro.configs.base`).

An architecture registers an :class:`ArchSpec` binding its exact published
configuration, a reduced same-family smoke configuration and its shape
cells.  :func:`get` and :func:`all_archs` load every config the port has:
the five LM archs, the four recsys archs, the GAT and the MCGI datasets.
:func:`all_archs` lists them in the order a fresh process registers them
(config module by module, as :func:`_ensure_loaded` imports them),
whichever config module an earlier import touched first.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
from typing import Any

# Step kinds a shape cell can lower.
TRAIN = "train"            # train_step (fwd+bwd+optimizer)
PREFILL = "prefill"        # LM prefill forward
DECODE = "decode"          # LM single-token decode vs KV cache
SERVE = "serve"            # recsys forward scoring
RETRIEVAL = "retrieval"    # 1 user vs n_candidates scoring
GNN_TRAIN = "gnn_train"    # full-graph or sampled-block train step
MCGI_SEARCH = "mcgi_search"  # distributed beam search (the paper's serving)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str
    meta: dict[str, Any]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # "lm" | "gnn" | "recsys" | "mcgi"
    config: Any
    smoke_config: Any
    shapes: tuple[ShapeCell, ...]
    source: str = ""                  # provenance tag

    def cell(self, name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == name:
                return c
        raise KeyError(f"{self.arch_id} has no shape {name!r}: "
                       f"{[c.name for c in self.shapes]}")


_REGISTRY: dict[str, ArchSpec] = {}
_MODULE_OF: dict[str, str] = {}     # arch id -> the config module's name
# The config modules, in the order _ensure_loaded imports them.
_CONFIG_MODULES = ("bert4rec", "deepfm", "deepseek_coder_33b",
                   "deepseek_v2_lite_16b", "dlrm_mlperf", "gat_cora",
                   "mcgi_datasets", "mind", "minicpm_2b", "qwen2_7b",
                   "qwen3_moe_30b_a3b")


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"{spec.arch_id} is registered already")
    _REGISTRY[spec.arch_id] = spec
    _MODULE_OF[spec.arch_id] = sys._getframe(1).f_globals.get("__name__", "")
    return spec


def get(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchSpec]:
    _ensure_loaded()
    rank = {f"repro_torch.configs.{m}": i
            for i, m in enumerate(_CONFIG_MODULES)}
    # A stable sort: registration order within a module.
    order = sorted(_REGISTRY, key=lambda a: rank.get(_MODULE_OF[a],
                                                     len(rank)))
    return {a: _REGISTRY[a] for a in order}


def _ensure_loaded() -> None:
    # Importing a config module registers it (once: modules import once).
    for m in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def lm_shapes() -> tuple[ShapeCell, ...]:
    """The four LM shape cells shared by the reference's LM archs."""
    note_500k = ("decode vs 524288-token KV cache is O(S)/step and runs; a "
                 "500k *prefill* would be quadratic, so full-attention "
                 "archs skip it.")
    return (
        ShapeCell("train_4k", TRAIN, {"seq": 4096, "batch": 256}),
        ShapeCell("prefill_32k", PREFILL, {"seq": 32768, "batch": 32}),
        ShapeCell("decode_32k", DECODE, {"seq": 32768, "batch": 128}),
        ShapeCell("long_500k", DECODE, {"seq": 524288, "batch": 1},
                  note=note_500k),
    )


# The four shape cells shared by the recsys archs.
RECSYS_SHAPES = (
    ShapeCell("train_batch", TRAIN, {"batch": 65536}),
    ShapeCell("serve_p99", SERVE, {"batch": 512}),
    ShapeCell("serve_bulk", SERVE, {"batch": 262144}),
    ShapeCell("retrieval_cand", RETRIEVAL,
              {"batch": 1, "n_candidates": 1_000_000}),
)
