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


#: spacing of the 16-bit dtypes' subnormals: the absolute error of a value
#: rounded into them
_TINY = {torch.bfloat16: 2.0 ** -133, torch.float16: 2.0 ** -24}


def bwd_kernel_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dout: torch.Tensor, want, causal: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elementwise bounds on |kernel − plain version| for the backward's
    (dq, dk, dv), ``want`` the plain fp32 vjp of the forward (16-bit
    operands in the model layout: q, dout (B, Sq, K, G, hd), k, v
    (B, Sk, K, hd)).  Derived as :func:`kernel_tolerance` derives the
    forward's: with s the dtype's relative spacing and t its subnormal
    spacing, a value x rounded to the input dtype moves by at most
    r(x) = s·|x| + t (twice the rounding's own bound), and

    * dV: r(dV) (the gradient may round to a neighbour) plus r(P)ᵀ|dO|,
      P rounded for the Pᵀ dO product;
    * dK, dQ: r(dK), r(dQ) plus scale · Mᵀ|Q| and scale · M|K| with
      M = r(dS) + s·P∘E, E the row sums of |dO|∘|O|: dS is rounded for its
      products, and the kernel's D = rowsum(dO∘O) reads the output
      rounded to the input dtype, where the plain vjp's reads it in fp32.

    Every sum the kernel takes in fp32 in another order adds far less than
    these.  The absolute sums hold each element to its own scale, so a
    zeroed tile or a query head's gradient swapped for its neighbour's is
    well outside them.  P, S and the sums are fp32 from the inputs here."""
    dq, dk, dv = (w.float().abs() for w in want)
    s_, t_ = _SPACING[q.dtype], _TINY[q.dtype]
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    scale = hd ** -0.5
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    vis = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        vis = torch.arange(sq, device=q.device)[:, None] >= \
            torch.arange(sk, device=q.device)[None, :]
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    p = torch.softmax(s.masked_fill(~vis, -1e30), dim=-1)
    del s
    o = torch.einsum("bkgqs,bskh->bqkgh", p, vf)
    e = torch.einsum("bqkgh,bqkgh->bkgq", df.abs(), o.abs())
    d = torch.einsum("bqkgh,bqkgh->bkgq", df, o)
    del o
    tv = s_ * dv + t_ + torch.einsum("bkgqs,bqkgh->bskh", s_ * p + t_ * vis,
                                df.abs())
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", df, vf) - d[..., None])
    m = s_ * ds.abs() + t_ * vis + s_ * p * e[..., None]
    del ds, p
    tk = s_ * dk + t_ + scale * torch.einsum("bkgqs,bqkgh->bskh", m, qf.abs())
    tq = s_ * dq + t_ + scale * torch.einsum("bkgqs,bskh->bqkgh", m, kf.abs())
    return tq, tk, tv
