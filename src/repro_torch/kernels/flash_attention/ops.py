"""Model-facing flash attention (port of
``repro.kernels.flash_attention.ops``): the GQA layout and the gradient.

``attention_apply`` (``repro_torch.models.layers``) calls
:func:`flash_attention_gqa` with q (B, S, K, G, hd) and k/v (B, S, K, hd).
It is one op, ``repro_torch::flash_attention``:

* its implementation launches the kernel on the model layout for CUDA
  tensors (each query head reads its shared KV head; the reference's
  wrapper repeats K/V G times instead) and runs the plain version
  :func:`_ref_gqa` for CPU tensors;
* ``register_fake`` gives its output shape, so the op walk on meta tensors
  sees one op and allocates nothing;
* its backward recomputes :func:`_ref_gqa` on the saved q/k/v and
  differentiates it — what the reference's ``custom_vjp`` does (it has no
  backward kernel either).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.fused.ops import _vjp


def _ref_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    """Reference GQA attention in the model layout (fp32 softmax)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.to(q.dtype)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref_gqa(q, k, v, causal)
    return fk.flash_attention_grouped(q, k, v, causal=causal)


@_flash_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


def _flash_setup(ctx, inputs, output):
    q, k, v, ctx.causal = inputs
    ctx.save_for_backward(q, k, v)


def _flash_bwd(ctx, g):
    gq, gk, gv = _vjp(lambda a, b, c: _ref_gqa(a, b, c, ctx.causal),
                      ctx.saved_tensors, (g,))
    return gq, gk, gv, None


_flash_op.register_autograd(_flash_bwd, setup_context=_flash_setup)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q (B, Sq, K, G, hd), k/v (B, Sk, K, hd) → (B, Sq, K, G, hd)."""
    return _flash_op(q.contiguous(), k.contiguous(), v.contiguous(),
                     bool(causal))
