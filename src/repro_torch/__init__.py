"""PyTorch/CUDA port of the hierarchical-roofline toolkit (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module names and computes the same things with torch on an NVIDIA H100:

* machine characterization (paper §II-A): hand-written Hopper ERT
  kernels (``repro_torch.kernels``) measured into a :class:`MachineSpec`;
* application characterization (paper §II-B): an aten-op walk over meta
  tensors (``repro_torch.core.op_analysis``) plus CUDA-event timing of the
  same callable (``repro_torch.core.profiler``).

Importing the package needs neither a GPU, ``nvcc`` nor ``triton``: the
kernels build on first use.  Entry points run on the card unless the
caller passes ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""

from repro_torch.session.session import Session

__all__ = ["Session"]
