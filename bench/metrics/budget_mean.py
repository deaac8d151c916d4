"""The mean beam budget granted (``BatchResult.astats.budget``) over the
queries completed in the window."""


def read(run):
    batches = run.window_batches()
    nq = sum(b.idx.shape[0] for b in batches)
    return sum(b.budget for b in batches) / nq if nq else None
