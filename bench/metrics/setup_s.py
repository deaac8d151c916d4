"""From the process's start to the first timed submission: imports, data
generation, loading (or, in a fresh checkout, compiling) the kernels, the
MCGI build, the PQ tier and the warm-up batches."""


def read(run) -> float:
    return run.setup_s
