"""Runnable drivers (port of ``repro.launch``): ``train`` and ``serve``."""
