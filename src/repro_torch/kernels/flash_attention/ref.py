"""Plain PyTorch oracle for the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``)."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Sk, hd) → (BH, Sq, hd); fp32 softmax,
    masked scores -1e30, cast to q's dtype at the end."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", w, v.float()).to(q.dtype)


#: spacing of the 16-bit dtypes relative to a value (2^-mantissa bits)
_SPACING = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def kernel_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel − plain version| for output ``want``
    of the plain version (broadcastable against it).

    * fp32: 1e-5 · max|want| — the same fp32 math summed in another order;
    * bf16/fp16: s · (|want| + rowmax|want|), with s the dtype's relative
      spacing and the row max taken over head_dim.  The first term allows
      the two outputs to round to neighbouring values; the second allows
      for P rounded to the input dtype before the tensor-core PV product,
      an error that scales with the row's own outputs.  Held per row, a
      late query row (whose output averages about S keys and is small)
      cannot hide a wrong key tile under the large outputs of early rows.
    """
    a = want.float().abs()
    if want.dtype not in _SPACING:
        return torch.full_like(a[..., :1], 1e-5 * a.max().item())
    return _SPACING[want.dtype] * (a + a.amax(dim=-1, keepdim=True))
