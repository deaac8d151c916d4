"""Graph construction and search (port of :mod:`repro.core`)."""
