"""The PQ walk kernel's share of its bytes roofline, in %.

Both sides come from the profiled stretch.  Measured time: the device time
of ``KERNEL`` in it.  Least time: the bytes the walk needs
(:func:`bench.costs.beam_walk_pq_bytes`, from the counted hops and
evaluations and the configuration's degree and PQ m and K) for the batches
completed while the profiler recorded, over the card's HBM rate.  With two
batches in flight the walks recorded are not exactly those batches', but
each batch serves the same pool, so their count and work agree.
"""
from bench import costs

KERNEL = "beam_walk_kernel<1"       # the pq kind (KIND 1) of csrc/beam_step.cu


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_seconds(KERNEL)
    bw = costs.peak(run.device_kind, "hbm_bytes_per_s")
    batches = run.traced_batches()
    if seconds <= 0 or bw is None or not batches:
        return None
    cfg = run.cell.config
    need = sum(costs.beam_walk_pq_bytes(
        b.idx.shape[0], b.hops, b.evals, cfg["build"]["degree"],
        cfg["pq"]["m"], cfg["pq"]["k"]) for b in batches)
    return 100.0 * need / bw / seconds
