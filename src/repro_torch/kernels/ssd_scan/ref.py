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


# --------------------------------------------------------------------------
# the kernel's decomposition, in plain PyTorch
# --------------------------------------------------------------------------

def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to TF32, a 10-bit mantissa, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor,
            tf32: str | None = None) -> torch.Tensor:
    """``a @ b`` in fp32 as the kernels' tensor cores take it: ``None`` in
    fp32; ``"1x"`` with each operand rounded to TF32; ``"3x"`` with each
    operand split as hi + lo (hi its TF32 rounding, lo the TF32 rounding of
    the rest) and the product taken as lo·hi + hi·lo + hi·hi."""
    a, b = a.float(), b.float()
    if tf32 is None:
        return a @ b
    ah, bh = to_tf32(a), to_tf32(b)
    if tf32 == "1x":
        return ah @ bh
    if tf32 != "3x":
        raise ValueError(f"tf32 is None, '1x' or '3x', got {tf32!r}")
    al, bl = to_tf32(a - ah), to_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def chunk_cb(B_: torch.Tensor, C_: torch.Tensor, chunk: int,
             tf32: str | None = None) -> torch.Tensor:
    """C·Bᵀ of each chunk, undecayed: B_/C_ (B, S, N) → (B, chunks, Q, Q).
    It does not depend on the head (one group), so the kernel forms it
    once per (batch, chunk); the output pass reads only j ≤ i."""
    b, s, n = B_.shape
    q = min(chunk, s)
    bc = B_.float().reshape(b, s // q, q, n)
    cc = C_.float().reshape(b, s // q, q, n)
    return product(cc, bc.transpose(-1, -2), tf32)


def _cum(a: torch.Tensor, q: int) -> torch.Tensor:
    b, h, s = a.shape
    return a.float().reshape(b, h, s // q, q).cumsum(-1)


def chunk_increments(xdt: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
                     chunk: int, tf32: str | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's own state increment and total, from a zero state:
    inc_c = x_cᵀ (B_c ∘ exp(total_c − cum_c)) (B, H, chunks, P, N) and
    total_c (B, H, chunks).  The kernel forms them for every chunk but the
    last, whose increment only the final state would read."""
    b, h, s, p = xdt.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    cum = _cum(a, q)                                  # (B, H, nc, Q)
    total = cum[..., -1]
    w = (total[..., None] - cum).exp()
    x = xdt.float().reshape(b, h, s // q, q, p)
    bw = B_.float().reshape(b, 1, s // q, q, n) * w[..., None]
    return product(x.transpose(-1, -2), bw, tf32), total


def state_pass(inc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """The state entering each chunk: s_0 = 0, s_{c+1} = exp(total_c)·s_c
    + inc_c, elementwise over the chunks in order (B, H, chunks, P, N)."""
    states = torch.empty_like(inc)
    st = torch.zeros_like(inc[:, :, 0])
    for c in range(inc.shape[2]):
        states[:, :, c] = st
        st = total[:, :, c, None, None].exp() * st + inc[:, :, c]
    return states


def chunk_outputs(xdt: torch.Tensor, a: torch.Tensor, C_: torch.Tensor,
                  cb: torch.Tensor, states: torch.Tensor, chunk: int,
                  tf32: str | None = None) -> torch.Tensor:
    """y = (C·Bᵀ ∘ decay)·x + (exp(cum) ∘ C)·stateᵀ per (b, h, chunk), the
    mask applied before the exp; C's rows are scaled by exp(cum) before the
    product, as the kernel stores them (B, H, S, P)."""
    b, h, s, p = xdt.shape
    n = C_.shape[-1]
    q = min(chunk, s)
    cum = _cum(a, q)
    seg = cum[..., :, None] - cum[..., None, :]
    iq = torch.arange(q)
    decay = torch.where(iq[:, None] >= iq[None, :], seg,
                        float("-inf")).exp()
    m = cb[:, None] * decay                           # (B, H, nc, Q, Q)
    x = xdt.float().reshape(b, h, s // q, q, p)
    ce = C_.float().reshape(b, 1, s // q, q, n) * cum.exp()[..., None]
    y = product(m, x, tf32) + product(ce, states.transpose(-1, -2), tf32)
    return y.reshape(b, h, s, p)


def ssd_split(xdt: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
              C_: torch.Tensor, *, chunk: int = 128,
              tf32: str | None = None) -> torch.Tensor:
    """The kernel's decomposition on the kernel layout (the same function
    as :func:`ssd_ref`): C·Bᵀ per (batch, chunk), each chunk's increment,
    the pass over the chunks, then every chunk's output at once.
    ``tf32`` rounds every product's operands as :func:`product` says."""
    cb = chunk_cb(B_, C_, chunk, tf32)
    inc, total = chunk_increments(xdt, a, B_, chunk, tf32)
    states = state_pass(inc, total)
    return chunk_outputs(xdt, a, C_, cb, states, chunk, tf32)
