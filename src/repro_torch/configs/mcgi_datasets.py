"""The paper's dataset configurations (Table 2/3): the port's copy of
``repro/configs/mcgi_datasets.py``.

Build parameters (R, L_build, alpha range, m_PQ) are the paper's Table 2
values; the serving defaults are the jointly calibrated budget laws of the
reference.  Each dataset registers an :class:`ArchSpec` of family
``mcgi`` with a ``-smoke`` variant (n = 4096, 64 queries) and one
``serve`` shape cell, as the reference's registry has them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import base
from repro_torch.core import calibrate as calibrate_mod
from repro_torch.core.search import AdaptiveBeamBudget


@dataclasses.dataclass(frozen=True)
class McgiDatasetConfig:
    name: str
    n: int
    d: int
    degree: int          # R
    l_build: int         # L_build
    m_pq: int | None     # PQ bytes (None = full precision in memory tier)
    data_dtype: str      # "float32" | "uint8"
    alpha_min: float = 1.0
    alpha_max: float = 1.5
    queries: int = 4096          # global query batch for the serve step
    l_search: int = 128
    k: int = 10
    max_hops: int = 192
    # Adaptive budget-law serving defaults (Prop. 4.2 + calibration pass):
    # ``lam`` and ``l_min`` jointly calibrated against ``recall_target``
    # (smallest feasible budget floor, then largest feasible lam there).
    lam: float = 0.35
    l_min: int | None = None     # None -> max(8, l_search // 8)
    probe_hops: int = 8
    hop_factor: int = 4
    recall_target: float = 0.95
    budget_buckets: int = 4      # ceiling of the auto-picked bucket family
    # Per-shard budget laws (calibrate_budget_law_per_shard on shard-local
    # held-out queries); None broadcasts the global (lam, l_min).
    shard_lam: tuple[float, ...] | None = None
    shard_l_min: tuple[int, ...] | None = None

    def beam_budget(self) -> AdaptiveBeamBudget:
        """The serving engine's budget law for this dataset: l_max =
        l_search, l_min the calibrated floor (default: an eighth, floor 8)."""
        l_min = self.l_min if self.l_min is not None else max(
            8, self.l_search // 8)
        return AdaptiveBeamBudget(
            l_min=min(l_min, self.l_search), l_max=self.l_search,
            lam=self.lam, probe_hops=self.probe_hops,
            hop_factor=self.hop_factor)

    def calibrated_beam_budget(self, eval_recall) -> AdaptiveBeamBudget:
        """Re-fit lam alone against this dataset's recall target
        (``eval_recall`` measures one candidate law on held-out queries:
        :func:`repro_torch.core.calibrate.exact_recall_eval` or
        ``tiered_recall_eval``); the stored ``lam`` is the seed."""
        base = self.beam_budget()
        return calibrate_mod.calibrate_budget_law(
            eval_recall, base, self.recall_target).budget_cfg(base)

    def shard_budget_laws(self, n_shards: int):
        """Per-shard (lam (S,) float32, l_min (S,) int32) arrays for the
        distributed step.  Stored per-shard fits must have ``n_shards``
        entries; with none stored the global law broadcasts (results equal
        to the scalar law's)."""
        base = self.beam_budget()
        if self.shard_lam is not None or self.shard_l_min is not None:
            lam = (self.shard_lam if self.shard_lam is not None
                   else (base.lam,) * n_shards)
            l_min = (self.shard_l_min if self.shard_l_min is not None
                     else (base.l_min,) * n_shards)
            if len(lam) != n_shards or len(l_min) != n_shards:
                raise ValueError(f"{len(lam)} lam / {len(l_min)} l_min "
                                 f"entries for {n_shards} shards")
            return np.asarray(lam, np.float32), np.asarray(l_min, np.int32)
        return (np.full((n_shards,), base.lam, np.float32),
                np.full((n_shards,), base.l_min, np.int32))

    def jointly_calibrated_beam_budget(self, make_eval) -> AdaptiveBeamBudget:
        """Joint (lam, l_min) re-fit against this dataset's recall target
        (``make_eval`` builds an evaluator specialised to one candidate
        floor)."""
        base = self.beam_budget()
        return calibrate_mod.calibrate_budget_law_joint(
            make_eval, base, self.recall_target).budget_cfg(base)


DATASETS = {c.name: c for c in (
    McgiDatasetConfig("mcgi-sift1m", 1_000_000, 128, 64, 100, None, "float32",
                      lam=0.25, l_min=8),
    McgiDatasetConfig("mcgi-glove100", 1_200_000, 100, 64, 100, None,
                      "float32", lam=0.3, l_min=8),
    McgiDatasetConfig("mcgi-gist1m", 1_000_000, 960, 96, 150, None, "float32",
                      lam=0.5, l_min=16),
    McgiDatasetConfig("mcgi-sift1b", 1_000_000_000, 128, 32, 50, 16, "uint8",
                      lam=0.25, l_min=8),
    McgiDatasetConfig("mcgi-t2i1b", 1_000_000_000, 200, 32, 50, 16, "float32",
                      lam=0.45, l_min=16),
)}


def _smoke(cfg: McgiDatasetConfig) -> McgiDatasetConfig:
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n=4096, queries=64, l_search=32,
        max_hops=64, degree=min(cfg.degree, 16), d=min(cfg.d, 64),
    )


for _cfg in DATASETS.values():
    base.register(
        base.ArchSpec(
            arch_id=_cfg.name,
            family="mcgi",
            config=_cfg,
            smoke_config=_smoke(_cfg),
            shapes=(
                base.ShapeCell(
                    "serve", base.MCGI_SEARCH,
                    {"queries": _cfg.queries, "k": _cfg.k},
                ),
            ),
            source="paper Table 2/3",
        )
    )
