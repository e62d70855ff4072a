"""Measured-time attribution and trace payloads (port of ``repro.trace``)."""
