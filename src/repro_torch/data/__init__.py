"""Synthetic datasets (port of :mod:`repro.data`)."""
from repro_torch.data.synthetic import REGISTRY, DatasetSpec, make_dataset  # noqa: F401
