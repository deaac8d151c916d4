"""Budget-law calibration: fit ``lam`` (and optionally ``hop_factor`` and
``l_min``) to a recall target on a held-out query sample (port of
:mod:`repro.core.calibrate`, single-host fits).

Prop. 4.2 gives the shape of the per-query budget law,
L(q) = C * exp(lam * (LID(q) - center)), but not its strength.  Measured
recall on a fixed sample is monotone non-increasing in ``lam``, so the fit
is a bisection for the **largest** ``lam`` that still meets the target;
``hop_factor`` doubles when even ``lam = lam_lo`` misses, and the joint fit
scans budget floors ``l_min`` ascending and returns the first feasible one.

The recall evaluators share one probe per base config: the probe depends
only on the shape knobs (l_min, l_max, probe_hops, lid_k), so each
candidate re-runs only the continue phase with its own budgets and hop
limits.  Deterministic end to end under a fixed seed.

The distributed path fits one law per shard
(:func:`calibrate_budget_law_per_shard` over
:func:`shard_exact_recall_evals`): each shard's sub-graph has its own
geometry, and the per-shard (lam, l_min) tensors reach the distributed step
as runtime inputs (:meth:`ShardCalibration.law_arrays`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import distance as distance_mod
from repro_torch.core import mapping as mapping_mod
from repro_torch.core import search as search_mod
from repro_torch.index.disk import _query_luts

Budget = search_mod.AdaptiveBeamBudget


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Outcome of a budget-law calibration run.

    ``lam`` is the largest value whose measured recall still meets
    ``target`` (at ``hop_factor``); ``history`` holds every
    (lam, hop_factor, recall) evaluation in order; ``l_min`` and
    ``joint_history`` ((l_min, lam, hop_factor, recall, achieved) per
    candidate floor) are set by the joint fit only.
    """

    lam: float
    hop_factor: int
    recall: float
    target: float
    achieved: bool
    history: tuple[tuple[float, int, float], ...]
    l_min: int | None = None
    joint_history: tuple[tuple[int, float, int, float, bool], ...] = ()

    def budget_cfg(self, base: Budget) -> Budget:
        """The base config with the fitted knobs substituted in."""
        out = dataclasses.replace(base, lam=self.lam,
                                  hop_factor=self.hop_factor)
        if self.l_min is not None:
            out = dataclasses.replace(out, l_min=self.l_min)
        return out


def bisect_lam(eval_recall: Callable[[float], float], target: float,
               lam_lo: float = 0.0, lam_hi: float = 1.0, tol: float = 0.02,
               max_iters: int = 8
               ) -> tuple[float, float, list[tuple[float, float]]]:
    """Largest ``lam`` in [lam_lo, lam_hi] with ``eval_recall(lam) >=
    target``, assuming recall is non-increasing in lam.  Returns
    (lam, recall_at_lam, [(lam, recall) evaluations]); when even ``lam_lo``
    misses, (lam_lo, recall_at_lo, history)."""
    history: list[tuple[float, float]] = []

    def f(lam: float) -> float:
        r = float(eval_recall(float(lam)))
        history.append((float(lam), r))
        return r

    r_lo = f(lam_lo)
    if r_lo < target:
        return lam_lo, r_lo, history
    r_hi = f(lam_hi)
    if r_hi >= target:
        return lam_hi, r_hi, history
    lo, hi, r_at_lo = lam_lo, lam_hi, r_lo
    for _ in range(max_iters):
        if hi - lo <= tol:
            break
        mid = 0.5 * (lo + hi)
        r_mid = f(mid)
        if r_mid >= target:
            lo, r_at_lo = mid, r_mid
        else:
            hi = mid
    return lo, r_at_lo, history


def holdout_sample(n_queries: int, sample: int, seed: int = 0) -> np.ndarray:
    """Deterministic held-out query subset, sorted (the reference's draw)."""
    sample = min(sample, n_queries)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_queries, size=sample, replace=False))


def calibrate_budget_law(eval_recall: Callable[[Budget], float],
                         base_cfg: Budget, recall_target: float, *,
                         lam_range: tuple[float, float] = (0.0, 1.0),
                         max_hop_factor: int = 16, tol: float = 0.02,
                         max_iters: int = 8) -> CalibrationResult:
    """Fit ``lam`` to ``recall_target``, doubling ``hop_factor`` from the
    base config's up to ``max_hop_factor`` whenever even
    ``lam = lam_range[0]`` misses."""
    history: list[tuple[float, int, float]] = []
    hop_factor = base_cfg.hop_factor
    while True:
        cfg_at = dataclasses.replace(base_cfg, hop_factor=hop_factor)

        def eval_lam(lam: float, _cfg=cfg_at) -> float:
            return eval_recall(dataclasses.replace(_cfg, lam=lam))

        lam, recall, lam_hist = bisect_lam(
            eval_lam, recall_target, lam_range[0], lam_range[1], tol=tol,
            max_iters=max_iters)
        history.extend((lm, hop_factor, r) for lm, r in lam_hist)
        if recall >= recall_target or hop_factor * 2 > max_hop_factor:
            return CalibrationResult(
                lam=float(lam), hop_factor=int(hop_factor),
                recall=float(recall), target=float(recall_target),
                achieved=bool(recall >= recall_target),
                history=tuple(history))
        hop_factor *= 2


def joint_l_min_candidates(base_cfg: Budget, floor: int = 2
                           ) -> tuple[int, ...]:
    """Default l_min grid of the joint fit: halving down from the base
    config's floor to ``floor``, ascending (max savings first)."""
    cands = [int(base_cfg.l_min)]
    while cands[-1] // 2 >= max(1, floor):
        cands.append(cands[-1] // 2)
    return tuple(sorted(set(cands)))


def calibrate_budget_law_joint(
        make_eval: Callable[[Budget], Callable[[Budget], float]],
        base_cfg: Budget, recall_target: float, *,
        l_min_candidates: tuple[int, ...] | None = None,
        lam_range: tuple[float, float] = (0.0, 1.0), max_hop_factor: int = 16,
        tol: float = 0.02, max_iters: int = 8) -> CalibrationResult:
    """Joint (lam, l_min) fit: the smallest feasible budget floor, then the
    largest feasible lam there.  ``make_eval(cfg)`` builds an evaluator
    specialised to one candidate floor.  If no floor is feasible the
    largest candidate's fit comes back with ``achieved=False``."""
    if l_min_candidates is None:
        l_min_candidates = joint_l_min_candidates(base_cfg)
    cands = sorted({int(c) for c in l_min_candidates})
    if not cands or cands[0] <= 0 or cands[-1] > base_cfg.l_max:
        raise ValueError(f"l_min candidates {cands} outside "
                         f"(0, {base_cfg.l_max}]")
    joint_hist: list[tuple[int, float, int, float, bool]] = []
    last = None
    for lm in cands:
        cfg_lm = dataclasses.replace(base_cfg, l_min=lm)
        result = calibrate_budget_law(
            make_eval(cfg_lm), cfg_lm, recall_target, lam_range=lam_range,
            max_hop_factor=max_hop_factor, tol=tol, max_iters=max_iters)
        joint_hist.append((lm, result.lam, result.hop_factor, result.recall,
                           result.achieved))
        last = result
        if result.achieved:
            return dataclasses.replace(result, l_min=lm,
                                       joint_history=tuple(joint_hist))
    return dataclasses.replace(last, l_min=cands[-1],
                               joint_history=tuple(joint_hist))


def calibrate_budget_law_per_class(
        make_eval: Callable[[Budget], Callable[[Budget], float]],
        base_cfg: Budget, recall_targets: dict[str, float], *,
        joint: bool = True, **fit_kw) -> dict[str, CalibrationResult]:
    """One budget law per QoS class (class name -> recall target), each
    fitted over the same evaluator factory and held-out sample, in the
    dict's order."""
    out: dict[str, CalibrationResult] = {}
    for name, target in recall_targets.items():
        if joint:
            out[name] = calibrate_budget_law_joint(
                make_eval, base_cfg, float(target), **fit_kw)
        else:
            out[name] = calibrate_budget_law(
                make_eval(base_cfg), base_cfg, float(target), **fit_kw)
    return out


def class_budget_cfgs(results: dict[str, CalibrationResult],
                      base_cfg: Budget) -> dict[str, Budget]:
    """Per-class serving configs from :func:`calibrate_budget_law_per_class`."""
    return {name: r.budget_cfg(base_cfg) for name, r in results.items()}


@dataclasses.dataclass(frozen=True)
class ShardCalibration:
    """Per-shard budget laws fitted by :func:`calibrate_budget_law_per_shard`:
    the fitted knobs, one entry per shard, and each shard's full
    :class:`CalibrationResult` in shard order."""

    lam: tuple[float, ...]
    l_min: tuple[int, ...]
    hop_factor: tuple[int, ...]
    results: tuple[CalibrationResult, ...]

    @property
    def achieved(self) -> bool:
        return all(r.achieved for r in self.results)

    def law_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The (lam (S,) float32, l_min (S,) int32) arrays the distributed
        step takes (``DistributedBackend(shard_laws=)``).  Deploy with
        :meth:`serving_budget`: ``hop_factor`` is not a per-shard input."""
        return (np.asarray(self.lam, np.float32),
                np.asarray(self.l_min, np.int32))

    def serving_budget(self, base: Budget) -> Budget:
        """``base`` with ``hop_factor`` raised to the largest fitted one, so
        no shard serves under a tighter hop limit than it was fitted at
        (hop limits are caps: easy shards still stop when their frontier
        closes)."""
        return dataclasses.replace(base, hop_factor=max(self.hop_factor))


def calibrate_budget_law_per_shard(
        make_shard_eval: Callable[[int], Callable[[Budget],
                                                  Callable[[Budget], float]]],
        base_cfg: Budget, recall_target: float, n_shards: int, *,
        joint: bool = True, **fit_kw) -> ShardCalibration:
    """One budget law per shard of a distributed index.

    ``make_shard_eval(s)`` returns shard ``s``'s evaluator factory (config
    -> recall evaluator on shard-local held-out queries, see
    :func:`shard_exact_recall_evals`).  Each shard runs the joint
    (lam, l_min) fit (the lam fit with ``joint=False``) against the same
    target, shard by shard."""
    results = []
    for s in range(n_shards):
        factory = make_shard_eval(s)
        if joint:
            r = calibrate_budget_law_joint(factory, base_cfg, recall_target,
                                           **fit_kw)
        else:
            r = calibrate_budget_law(factory(base_cfg), base_cfg,
                                     recall_target, **fit_kw)
        results.append(r)
    return ShardCalibration(
        lam=tuple(float(r.lam) for r in results),
        l_min=tuple(int(r.l_min if r.l_min is not None else base_cfg.l_min)
                    for r in results),
        hop_factor=tuple(int(r.hop_factor) for r in results),
        results=tuple(results))


def shard_exact_recall_evals(vectors, adj, entries, queries, n_shards: int, *,
                             k: int = 10, sample: int = 256, seed: int = 0,
                             device="cuda", mesh=None
                             ) -> Callable[[int], Callable]:
    """``make_shard_eval`` over a distributed layout: shard ``s`` owns rows
    ``[s*per, (s+1)*per)`` of ``vectors`` / ``adj`` (with shard-local ids),
    ``entries`` holds the per-shard medoids.  Shard recall is measured by
    the exact-distance adaptive walk against the shard's own exact top-k
    (one :func:`~repro_torch.core.distance.brute_force_topk` per shard,
    through the ``l2_distance`` and ``topk`` kernels on the card); every
    shard draws the same held-out sample.

    With ``mesh`` each shard is evaluated on its own device
    (``mesh.shard_devices[s]``), reading its rows there (the blocks of
    :class:`~repro_torch.distributed.mesh.ShardedRows`, or its rows of
    shard-major arrays, copied); without, every shard on ``device``."""
    devices = (list(mesh.shard_devices) if mesh is not None
               else [resolve_device(device)] * n_shards)
    on_dev: dict = {}

    def rows(a, s: int, dtype) -> torch.Tensor:
        if hasattr(a, "parts"):                   # ShardedRows
            return a.parts[s].to(device=devices[s], dtype=dtype)
        a = torch.as_tensor(a)
        per = a.shape[0] // n_shards
        return a[s * per:(s + 1) * per].to(device=devices[s], dtype=dtype)

    def make_shard_eval(s: int) -> Callable:
        d = devices[s]
        x_s = rows(vectors, s, torch.float32)
        adj_s = rows(adj, s, torch.int32)
        entry = rows(entries, s, torch.int32)[0]
        if d not in on_dev:
            on_dev[d] = torch.as_tensor(queries, dtype=torch.float32,
                                        device=d)
        q = on_dev[d]
        _, gt_s = distance_mod.brute_force_topk(q, x_s, k=k)

        def factory(cfg: Budget) -> Callable[[Budget], float]:
            return exact_recall_eval(x_s, adj_s, entry, q, gt_s, k=k,
                                     sample=sample, seed=seed, base_cfg=cfg)

        return factory

    return make_shard_eval


def _candidate_grants(cfg: Budget, q_lid: torch.Tensor):
    """Budgets and hop limits of one candidate config from a shared probe's
    LID estimates."""
    center = (torch.tensor(cfg.center, dtype=torch.float32,
                           device=q_lid.device)
              if cfg.center is not None else q_lid.mean())
    budgets = mapping_mod.adaptive_beam_budget(q_lid, cfg.lam, cfg.l_min,
                                               cfg.l_max, mu=center)
    return budgets, search_mod._bucket_hop_limits(cfg, budgets, None)


def _check_shape_knobs(cfg: Budget, base: Budget) -> None:
    """The shared probe state holds only while the shape knobs match: the
    fits vary lam, hop_factor and center alone."""
    same = (cfg.l_min == base.l_min and cfg.l_max == base.l_max
            and cfg.probe_hops == base.probe_hops and cfg.lid_k == base.lid_k)
    if not same:
        raise ValueError(f"calibration evaluator is specialised to probe "
                         f"knobs of {base}; got {cfg}")


def _holdout(queries, gt_ids, sample: int, seed: int, k: int, device):
    """The held-out queries and their ground-truth rows, on ``device``."""
    sel = holdout_sample(queries.shape[0], sample, seed)

    def rows(a):
        if isinstance(a, torch.Tensor):
            return a[torch.from_numpy(sel).to(a.device)]
        return torch.from_numpy(np.asarray(a)[sel])   # a fresh copy

    return (rows(queries).to(device, torch.float32),
            rows(gt_ids)[:, :k].to(device))


def exact_recall_eval(x, adj, entry, queries, gt_ids, *, k: int = 10,
                      sample: int = 256, seed: int = 0,
                      base_cfg: Budget | None = None
                      ) -> Callable[[Budget], float]:
    """Recall evaluator over the exact-distance adaptive engine on a
    held-out sample of ``queries`` (numpy or tensors; ``x``/``adj``/
    ``entry`` on the device the walk runs on).  The probe runs once, at the
    first evaluation; each candidate re-runs only the continue phase."""
    q_s, gt_s = _holdout(queries, gt_ids, sample, seed, k, x.device)
    probe = {}

    def eval_recall(cfg: Budget) -> float:
        if not probe:
            probe["base"] = base_cfg or cfg
            probe["state"], _, _, probe["q_lid"] = search_mod._probe_exact(
                x, adj, q_s, entry, probe["base"])
        _check_shape_knobs(cfg, probe["base"])
        budgets, hop_limits = _candidate_grants(cfg, probe["q_lid"])
        beam_ids, _, _, _ = search_mod._continue_exact(
            x, adj, probe["state"], q_s, budgets, hop_limits, probe["base"])
        return float(distance_mod.recall_at_k(beam_ids[:, :k], gt_s))

    return eval_recall


def tiered_recall_eval(index, queries, gt_ids, *, k: int = 10,
                       sample: int = 256, seed: int = 0,
                       base_cfg: Budget | None = None
                       ) -> Callable[[Budget], float]:
    """Recall evaluator over the deployed two-tier path (PQ-routed walk +
    full-precision rerank), with the shared-probe structure of
    :func:`exact_recall_eval`."""
    q_s, gt_s = _holdout(queries, gt_ids, sample, seed, k, index.device)
    luts = _query_luts(index, q_s)
    probe = {}

    def eval_recall(cfg: Budget) -> float:
        if not probe:
            probe["base"] = base_cfg or cfg
            probe["state"], _, _, probe["q_lid"] = search_mod._probe_pq(
                index.codes, index.graph.adj, luts, index.graph.entry,
                probe["base"])
        _check_shape_knobs(cfg, probe["base"])
        budgets, hop_limits = _candidate_grants(cfg, probe["q_lid"])
        beam_ids, _, _, _ = search_mod._continue_pq(
            index.codes, index.graph.adj, probe["state"], luts, budgets,
            hop_limits, probe["base"])
        ids, _ = search_mod._rerank_slow_tier(beam_ids, index.vectors, q_s, k)
        return float(distance_mod.recall_at_k(ids, gt_s))

    return eval_recall
