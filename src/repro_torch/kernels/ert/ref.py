"""Plain PyTorch versions of the ERT micro-kernels (port of
``repro.kernels.ert.ref``).

Each repeats the reference's jnp oracle op for op: the CPU tests hold
them against it, the wrappers run them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
Constants are cast to the input dtype as the reference's
``jnp.asarray(c, dtype)`` does.
"""

from __future__ import annotations

import torch


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def fma_chain_ref(x: torch.Tensor, n_iters: int = 64, ilp: int = 4
                  ) -> torch.Tensor:
    a, b = _const(1.0000001, x), _const(1e-7, x)
    accs = [x + _const(i, x) for i in range(ilp)]
    for _ in range(n_iters):
        accs = [acc * a + b for acc in accs]
    out = accs[0]
    for acc in accs[1:]:
        out = out + acc
    return out


def triad_ref(a: torch.Tensor, b: torch.Tensor, scale: float = 3.0
              ) -> torch.Tensor:
    return a * _const(scale, a) + b


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """fp32 product of the (exactly upcast) operands, cast at the end, as
    ``jnp.dot(..., preferred_element_type=f32).astype(out_dtype)``."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)
