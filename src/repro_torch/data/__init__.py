"""Deterministic synthetic data streams with host prefetch (port of
``repro.data``)."""
