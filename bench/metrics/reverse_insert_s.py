"""``build_mcgi(..., timings=)["reverse_insert"]``: the build's reverse-edge
insertion, clocked with the card synchronised at both ends."""


def read(run):
    return run.build_timings.get("reverse_insert")
