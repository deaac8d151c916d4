"""Graph construction and search (port of :mod:`repro.core`), the paper's
primary contribution plus its baselines.

Public surface, the reference's names:
  * LID estimation + calibration      — :mod:`repro_torch.core.lid`
  * Phi mapping (LID -> alpha)        — :mod:`repro_torch.core.mapping`
  * Adaptive robust prune             — :mod:`repro_torch.core.prune`
  * Offline build (Algorithm 1)       — :mod:`repro_torch.core.build`
  * Online build  (Algorithm 2)       — :mod:`repro_torch.core.online`
  * Batched beam search (exact / PQ)  — :mod:`repro_torch.core.search`
  * Budget-law calibration (lam fit)  — :mod:`repro_torch.core.calibrate`
  * Baselines: Vamana / IVF / HNSW    — build.py / ivf.py / hnsw.py
  * Theory oracles (Prop. 4.3)        — :mod:`repro_torch.core.theory`

``repro_torch.core.calibrate`` is the calibration *module*; the LID
population-stats helper is :func:`repro_torch.core.lid.calibrate`.  Every
entry point runs on the card unless the caller passes ``device="cpu"``.

The names resolve on first use (PEP 562): ``pq`` and ``index`` import
modules of this package, so an eager import here would be circular.  The
reference's data generators and PQ transforms are exported by
:mod:`repro_torch.data` and :mod:`repro_torch.pq`.
"""

import importlib

_EXPORTS = {
    "repro_torch.core.build": ("BuildConfig", "block_layout", "build_mcgi",
                               "build_vamana"),
    "repro_torch.core.distance": ("brute_force_topk", "knn_graph",
                                  "recall_at_k"),
    "repro_torch.core.lid": ("LidProfile", "estimate_dataset_lid",
                             "lid_from_dists"),
    "repro_torch.core.mapping": ("ALPHA_MAX", "ALPHA_MIN", "AlphaMapping",
                                 "phi"),
    "repro_torch.core.online": ("build_online_mcgi",),
    "repro_torch.core.search": (
        "AdaptiveBeamBudget", "AdaptiveStats", "SearchStats",
        "beam_search_exact", "beam_search_exact_adaptive", "beam_search_pq",
        "beam_search_pq_adaptive", "budget_bucket_ceilings", "medoid"),
    "repro_torch.core.types": ("GraphIndex",),
    "repro_torch.core.calibrate": (
        "CalibrationResult", "calibrate_budget_law",
        "calibrate_budget_law_joint", "exact_recall_eval",
        "tiered_recall_eval"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
_SUBMODULES = ("build", "calibrate", "distance", "hnsw", "ivf", "lid",
               "mapping", "online", "prune", "search", "theory", "types")
__all__ = sorted(_HOME) + list(_SUBMODULES)


def __getattr__(name: str):
    if name in _HOME:
        value = getattr(importlib.import_module(_HOME[name]), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return __all__
