"""Synthetic datasets (port of :mod:`repro.data`)."""
from repro_torch.data.synthetic import (  # noqa: F401
    REGISTRY,
    DatasetSpec,
    gaussian_subspace_clusters,
    make_dataset,
    mixture_of_manifolds,
    swiss_roll_hd,
    uniform_hypercube,
)
