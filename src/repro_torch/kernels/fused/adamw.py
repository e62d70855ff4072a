"""Fused AdamW leaf update (port of ``repro.kernels.fused.adamw``).

One pass per leaf: g, m, v and p are read once and p′, m′, v′ written once,
every intermediate in registers.  The math follows the reference
expression for expression in fp32; the bias corrections
``bc = (1 - b1^t, 1 - b2^t)`` come as a (2,) fp32 tensor on the device, so
a step needs no host sync.  Hyperparameters are plain floats.

:func:`fused_adamw` is functional like the reference: it returns new
tensors.  With ``inplace=True`` it writes p′, m′, v′ over p, m, v instead —
the train step uses that to avoid holding a second copy of the weights and
both moments (at glm4-9b width that copy would be 24.7 GB of fp32).

On a CUDA tensor it launches the hand-written kernel in ``csrc/fused.cu``;
on a CPU tensor it runs the plain version :func:`adamw_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.fused import common

#: FLOPs per element: the two moments (3 + 4), the corrected step (5) and
#: the decayed write (4)
FLOPS_PER_ELEMENT = 16

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0


def adamw_ref(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              p: torch.Tensor, bc: torch.Tensor, *, lr: float, b1: float,
              b2: float, eps: float, weight_decay: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the reference's ``adamw_update`` leaf math in fp32,
    each result cast back to its leaf's dtype."""
    bc1, bc2 = bc[0], bc[1]
    gf = g.float()
    m2 = b1 * m.float() + (1 - b1) * gf
    v2 = b2 * v.float() + (1 - b2) * gf * gf
    step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    pf = p.float()
    newp = pf - lr * (step + weight_decay * pf)
    return newp.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)


def fused_adamw(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                p: torch.Tensor, bc: torch.Tensor, *, lr: float = 3e-4,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.1, inplace: bool = False,
                config: kc.KernelConfig | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's AdamW update in one pass → (p′, m′, v′).

    g, m, v, p: one shape, each f32 or bf16.  ``bc``: (2,) fp32, the bias
    corrections ``1 - beta^count``.  ``inplace=True`` writes the results
    over p, m, v and returns them.
    """
    global LAUNCHES
    if not g.shape == m.shape == v.shape == p.shape:
        raise ValueError(f"AdamW leaf shapes differ: g {tuple(g.shape)}, m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)}, p "
                         f"{tuple(p.shape)}")
    if tuple(bc.shape) != (2,) or bc.dtype != torch.float32:
        raise ValueError(f"bc must be a (2,) float32 tensor, got "
                         f"{tuple(bc.shape)}/{bc.dtype}")
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if all(t.device.type == "cpu" for t in (g, m, v, p, bc)):
        out = adamw_ref(g, m, v, p, bc, **hyper)
        if not inplace:
            return out
        for dst, src in zip((p, m, v), out):
            dst.copy_(src)
        return p, m, v
    cfg = kc.for_launch("fused_adamw", config, p, (p.numel(),))
    build.require_cuda(g, m, v, p, bc, align=1)
    codes = [common.code(t) for t in (g, m, v, p)]
    outs = (p, m, v) if inplace else tuple(
        torch.empty_like(t) for t in (p, m, v))
    n = p.numel()
    if n == 0:
        return outs
    blocks, threads = common.flat_grid(n, 4, cfg, p)
    lib = build.load("fused")
    err = lib.fused_adamw(
        g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(), bc.data_ptr(),
        *(t.data_ptr() for t in outs), n, float(lr), float(b1), float(b2),
        float(1 - b1), float(1 - b2), float(eps), float(weight_decay),
        *codes, blocks, threads, build.stream_of(p))
    build.check(lib, err, "fused_adamw")
    LAUNCHES += 1
    return outs


def hbm_bytes(n: int, itemsize: int = 4) -> float:
    """Fused traffic: g, m, v, p in and p′, m′, v′ out, one pass each, plus
    the 8-byte ``bc`` operand (which the reference's ``7 * n * itemsize``
    leaves out)."""
    return float(7 * n * itemsize + 8)


def flops(n: int) -> float:
    return float(FLOPS_PER_ELEMENT * n)
