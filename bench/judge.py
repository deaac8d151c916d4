"""The comparison that decides ``correct``.

It runs once the window has closed, the peak memory has been read and the
program's state is freed.  Each check the configuration's ``correct``
section names is a reader ``bench/checks/<name>.py`` whose ``reading(ctx)``
returns one number, held to the section's ``limit`` in the section's
``sense``: ``"max"`` (the reading may not exceed it) or ``"min"`` (may not
fall below it).  A reader that raises gives no number, which fails.
"""
from __future__ import annotations

import dataclasses
import math
import traceback

import numpy as np
import torch

from bench import spec
from bench.reference import knn


@dataclasses.dataclass
class Batch:
    """One batch the client handed in, and what came back for it."""

    idx: np.ndarray                  # (Q,) rows of the query pool
    handed: float                    # host clock when handed to the engine
    done: float | None = None        # host clock when its results were back
    in_window: bool = False          # done inside the window
    traced: bool = False             # done while the profiler recorded
    ids: np.ndarray | None = None    # (Q, k)
    d2: np.ndarray | None = None     # (Q, k)
    hops: float = 0.0                # sums over the batch's queries
    evals: float = 0.0
    budget: float = 0.0


@dataclasses.dataclass
class Context:
    """What the checks and metric readers read: the benchmark's own data
    (on the device), the batches, and the program's outputs (host copies
    made before its state was freed)."""

    config: dict
    x: torch.Tensor
    queries: torch.Tensor
    batches: list
    outputs: dict
    _gt: torch.Tensor | None = None

    @property
    def k(self) -> int:
        return int(self.config["serve"]["k"])

    def answered(self) -> list:
        return [b for b in self.batches if b.ids is not None]

    def gt(self) -> torch.Tensor:
        """The reference's exact top-k ids (float64) of every pool query."""
        if self._gt is None:
            self._gt = knn.exact_topk(self.x, self.queries, self.k)[0]
        return self._gt

    def hits(self, batches) -> tuple[int, int]:
        """(reference neighbours found, queries) over ``batches``."""
        gt, found, nq = self.gt(), 0, 0
        for b in batches:
            nq += b.idx.shape[0]
            if self.well_formed(b):
                ids = torch.as_tensor(b.ids, device=gt.device).long()
                idx = torch.as_tensor(b.idx, device=gt.device).long()
                found += int(knn.recall_hits(ids, gt[idx]).sum())
        return found, nq

    def well_formed(self, b: Batch) -> bool:
        """Whether ``b`` has a (Q, k) answer of ids and d2 (a batch that
        has not finds nothing; ``bad_answers`` counts it)."""
        shape = (b.idx.shape[0], self.k)
        return (b.ids is not None and b.ids.shape == shape
                and b.d2.shape == shape)


def run_checks(root, ctx: Context) -> dict:
    """{name: {"value", "limit", "sense", "ok"}} for every check the
    configuration names, in its order."""
    out = {}
    for name, rule in ctx.config["correct"].items():
        try:
            value = float(spec.load_reader(root, "checks", name).reading(ctx))
        except Exception:             # a check that gives no number fails
            traceback.print_exc()
            value = None
        limit = float(rule["limit"])
        if value is None or math.isnan(value):
            ok = False
        elif rule["sense"] == "max":
            ok = value <= limit
        elif rule["sense"] == "min":
            ok = value >= limit
        else:
            raise ValueError(f"check {name}: sense {rule['sense']!r}")
        out[name] = {"value": value, "limit": limit, "sense": rule["sense"],
                     "ok": ok}
    return out
