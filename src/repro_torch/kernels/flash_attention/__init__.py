"""Causal GQA flash attention (port of ``repro.kernels.flash_attention``):
the forward hand-written for Hopper in ``csrc/flash.cu``, the plain
versions in :mod:`.ref`, and the model-facing op in :mod:`.ops`."""
