"""``BatchResult.stats.hops`` (probe and continue) summed over the queries
completed in the window, over their count."""


def read(run):
    batches = run.window_batches()
    nq = sum(b.idx.shape[0] for b in batches)
    return sum(b.hops for b in batches) / nq if nq else None
