"""Session workflow (port of ``repro.session``)."""
