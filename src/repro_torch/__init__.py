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

import torch

from repro_torch.session.session import Session

__all__ = ["Session"]

# On some CPU hosts the first concurrent call of PyTorch's host vector math
# (``exp``, ``log``) hands one intra-op thread's share of the elements to a
# less accurate approximation, up to 1e-4 off (``tools/torch_first_exp.py``
# reproduces it).  One small call on the importing thread first sets that
# path up for the whole process, so the port's CPU paths never meet it.
torch.ones(8).exp()
