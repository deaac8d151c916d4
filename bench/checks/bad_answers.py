"""Queries handed in whose answer never came or is malformed: not (Q, k),
an id outside [0, N), an id twice in one answer, or squared distances not
finite and ascending.  Exact: the limit is 0.  An answer that came after
the window is late, not missing; it is judged like any other."""
import numpy as np


def reading(ctx) -> float:
    n, bad = ctx.x.shape[0], 0
    for b in ctx.batches:
        if not ctx.well_formed(b):
            bad += b.idx.shape[0]
            continue
        ids, d2 = b.ids.astype(np.int64), b.d2.astype(np.float64)
        row_bad = ((ids < 0) | (ids >= n)).any(1)
        srt = np.sort(ids, axis=1)
        row_bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
        row_bad |= ~np.isfinite(d2).all(1)
        row_bad |= (np.diff(d2, axis=1) < 0).any(1)
        bad += int(row_bad.sum())
    return bad
