"""Queries whose results came back inside the window, over the window's
seconds: all the work over all the time, not a median of chunks."""


def read(run) -> float:
    return sum(b.idx.shape[0] for b in run.window_batches()) / run.seconds
