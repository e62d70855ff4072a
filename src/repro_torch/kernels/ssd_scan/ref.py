"""Plain PyTorch oracle for the SSD scan kernel (port of
``repro.kernels.ssd_scan.ref``): the model's own chunked SSD math
(:func:`repro_torch.models.ssm.ssd_chunked`), and the tolerance the
kernel is held to against it."""

from __future__ import annotations

import torch

#: the kernel's bound relative to each (b, h, chunk) block's max |plain|
REL_TOL = 1e-4


def ssd_ref(xdt: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
            C_: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Same layout as the kernel: xdt (B, H, S, P), a (B, H, S),
    B_/C_ (B, S, N) → y (B, H, S, P)."""
    from repro_torch.models.ssm import ssd_chunked
    xh = xdt.transpose(1, 2)                # (B, S, H, P)
    al = a.transpose(1, 2)                  # (B, S, H)
    return ssd_chunked(xh, al, B_, C_, min(chunk, xh.shape[1])
                       ).transpose(1, 2)


def kernel_tolerance(want: torch.Tensor, chunk: int) -> torch.Tensor:
    """Bound on |kernel − plain version| for the plain output ``want``
    (B, H, S, P), broadcastable against it: :data:`REL_TOL` times the
    largest |want| of each (b, h, chunk) block.

    Held per block, a wrong state carried into a late chunk cannot hide
    under the larger outputs of other chunks or heads, as it could under
    one bound for the whole output.  An all-zero block is held to zero
    (the floor is the smallest normal fp32)."""
    b, h, s, _ = want.shape
    q = min(chunk, s)
    blocks = want.float().abs().reshape(b, h, s // q, q, -1).amax(dim=(3, 4))
    tol = REL_TOL * blocks + torch.finfo(torch.float32).tiny
    return tol.repeat_interleave(q, dim=2)[..., None]
