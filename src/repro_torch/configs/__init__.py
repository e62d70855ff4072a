"""Model / run configuration (port of ``repro.configs``)."""
