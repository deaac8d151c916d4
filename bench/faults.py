"""Faults planted under the timed path, by name, to show that the checks of
``correct`` catch them: the CPU tests plant them in tiny runs, and
``bench/readings.py`` reads the checks under them at a cell's own size on
the card.

- ``walk_unchanged``: the walk returns its state unchanged (the beam never
  leaves the entry);
- ``half_batch``: half of each batch's answers left out;
- ``answer_altered``: one id of each batch altered where the rerank
  produces it;
- ``budget_l_min``: every query granted the budget law's floor ``l_min``;
- ``other_query_rows``: each query reranks the beam the previous query of
  its batch walked (valid ids, their true distances, the wrong
  neighbours).
"""
from __future__ import annotations

import contextlib

NAMES = ("walk_unchanged", "half_batch", "answer_altered", "budget_l_min",
         "other_query_rows")


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def plant(name: str):
    """A context manager under which fault ``name`` is in the program."""
    import torch

    from repro_torch.core import mapping, search
    from repro_torch.kernels import ops
    from repro_torch.serving import engine

    if name == "walk_unchanged":
        return _patched(ops, "beam_walk", lambda state, *a, **kw: state)
    if name == "half_batch":
        serve = engine.SearchEngine.search_batches

        def half(self, batches, **kw):
            for res in serve(self, batches, **kw):
                keep = res.ids.shape[0] // 2
                res.ids, res.d2 = res.ids[:keep], res.d2[:keep]
                yield res

        return _patched(engine.SearchEngine, "search_batches", half)
    rerank = search._rerank_from_vecs
    if name == "answer_altered":
        def altered(beam_ids, vecs, queries, k):
            ids, d2 = rerank(beam_ids, vecs, queries, k)
            ids = ids.clone()
            n = int(beam_ids.max()) + 1
            ids[0, 0] = (ids[0, 0] + 1) % n
            return ids, d2

        return _patched(search, "_rerank_from_vecs", altered)
    if name == "other_query_rows":
        def other(beam_ids, vecs, queries, k):
            return rerank(beam_ids.roll(1, 0), vecs.roll(1, 0), queries, k)

        return _patched(search, "_rerank_from_vecs", other)
    if name == "budget_l_min":
        law = mapping.adaptive_beam_budget

        def floor(lid, lam, l_min, l_max, mu=None):
            budget = law(lid, lam, l_min, l_max, mu)
            return torch.minimum(budget, torch.as_tensor(
                l_min, dtype=budget.dtype, device=budget.device))

        return _patched(mapping, "adaptive_beam_budget", floor)
    raise KeyError(f"no fault {name!r} (have {NAMES})")
