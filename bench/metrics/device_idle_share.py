"""1 - the union of the card's kernel and copy intervals over the profiled
stretch's length, in % (``bench.trace``)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
