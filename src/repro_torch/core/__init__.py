"""Machine model, aten-op analysis, roofline math and reports (port of
``repro.core``).  Submodules are imported directly; this package imports
nothing at load time."""
