"""The one traffic generator: it reads a mix's parameters from
``bench/traffic/<name>.json``.  It drives one client in a closed loop: the
client hands the engine its next batch when the engine pulls it
(``SearchEngine.search_batches`` keeps two batches in flight), so a slow
system receives less load.  The query pool is served again and again, each
pass in a new order drawn from the seed, cut into batches.

Keys of a mix (any other key is refused, so a mix cannot ask for traffic
this generator does not make):

- ``batch``: queries a batch (a batch the size of the pool is one whole
  pass);
- ``warmup_batches``: batches served before the window (every shape the
  window uses, so nothing compiles or allocates anew inside it);
- ``trace_skip_batches``, ``trace_batches``: with ``--trace 1``, the
  profiler starts after that many completed window batches and records that
  many more;
- ``why``: what the mix stands for, in words.

Every seed gets the same sizes and the same number of queries a batch; only
the order differs.
"""
from __future__ import annotations

import numpy as np

KEYS = {"batch": 1, "warmup_batches": 0, "trace_skip_batches": 0,
        "trace_batches": 1}             # each count's least value


def check(traffic: dict) -> None:
    unknown = set(traffic) - set(KEYS) - {"why"}
    if unknown:
        raise ValueError(f"keys this generator does not read: {sorted(unknown)}")
    for key, least in KEYS.items():
        if int(traffic[key]) < least:
            raise ValueError(f"{key} = {traffic[key]}")


def batch_indices(pool: int, traffic: dict, seed: int):
    """Endless stream of (batch,) int64 index arrays into a pool of
    ``pool`` queries."""
    check(traffic)
    batch = int(traffic["batch"])
    rng = np.random.default_rng(seed)
    buf = np.empty((0,), dtype=np.int64)
    while True:
        while buf.shape[0] < batch:
            buf = np.concatenate([buf, rng.permutation(pool)])
        yield buf[:batch]
        buf = buf[batch:]
