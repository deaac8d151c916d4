"""Host calls that wait on the card (``bench.trace.SYNC_CALLS``) in the
profiled stretch, over the window batches completed in it."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.batches == 0:
        return None
    return run.trace.syncs / run.trace.batches
