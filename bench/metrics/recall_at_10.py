"""Mean over the queries completed in the window of the share of the
reference's exact top-10 (float64) found in the program's top-10."""


def read(run):
    found, nq = run.ctx.hits(run.window_batches())
    return found / (nq * run.ctx.k) if nq else None
