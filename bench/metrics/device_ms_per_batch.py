"""Device busy time a batch, in ms: the union of the card's kernel and copy
intervals in the profiled stretch over the batches completed in it.  The
work the card does for a batch, steadier than ``qps``, which the host's
pace between processes moves (PERF.md)."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.batches == 0:
        return None
    return 1e3 * run.trace.busy_s / run.trace.batches
