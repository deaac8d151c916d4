"""The bytes a kernel needs for its inputs, and the peaks it is held to.

:func:`beam_walk_pq_bytes` is the least the PQ walk (``beam_step.pq``,
``beam_walk_kernel<1, ...>``) must read for a batch, counted as the
``bound ms (bytes)`` column of ``PERF.md``'s kernel table counts it, by
what these inputs need: one adjacency row of ``degree`` int32 ids a hop, ``m``
code bytes a distance evaluation, and each query's (m, K) float32 lookup
table once.
"""
from __future__ import annotations

import json
import pathlib

PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"


def beam_walk_pq_bytes(queries: int, hops: float, evals: float, degree: int,
                       m: int, k: int) -> float:
    """Bytes of a batch of ``queries`` lanes that took ``hops`` hops and
    ``evals`` distance evaluations in all."""
    return hops * degree * 4 + evals * m + queries * m * k * 4


def peak(device_kind: str, key: str) -> float | None:
    """The data sheet's ``key`` for the first table entry that
    ``device_kind`` starts with; None for a card not in the table."""
    with open(PEAKS) as f:
        table = json.load(f)["devices"]
    for name, values in table.items():
        if device_kind.startswith(name):
            return float(values[key])
    return None
