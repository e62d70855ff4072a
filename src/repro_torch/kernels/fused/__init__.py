"""Fused memory-bound kernels of the train step (port of
``repro.kernels.fused``): RMSNorm, residual RMSNorm, the SwiGLU/GeGLU
epilogue and the AdamW leaf update, hand-written for Hopper in
``csrc/fused.cu``, with the model-facing routing in :mod:`.ops`."""
