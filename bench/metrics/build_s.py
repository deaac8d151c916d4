"""Sum of ``build_mcgi(..., timings=)``'s phases (lid_knn, rewire_walks,
prune, reverse_insert), each clocked with the card synchronised at both
ends."""


def read(run):
    return sum(run.build_timings.values()) if run.build_timings else None
