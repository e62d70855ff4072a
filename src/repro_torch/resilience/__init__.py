"""Fault injection (port of ``repro.resilience``; the fault plan
alone so far)."""
