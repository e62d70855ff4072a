"""Chunked SSD scan (port of ``repro.kernels.ssd_scan``): the forward
hand-written for Hopper in ``csrc/ssd.cu``, the plain versions in
:mod:`.ref`, and the model-facing op in :mod:`.ops`."""
