"""Model-facing flash attention (port of
``repro.kernels.flash_attention.ops``): the GQA layout and the gradient.

``attention_apply`` (``repro_torch.models.layers``) calls
:func:`flash_attention_gqa` with q (B, S, K, G, hd) and k/v (B, S, K, hd).
It is one op, ``repro_torch::flash_attention``, which returns the output
and each query row's log-sum-exp, lse (B, K, G, Sq) fp32 (the (B, H, Sq)
buffer the kernel writes, seen in the grouped layout):

* its implementation launches the kernel on the model layout for CUDA
  tensors (each query head reads its shared KV head; the reference's
  wrapper repeats K/V G times instead) and runs the plain version
  :func:`_ref_gqa_lse` for CPU tensors;
* ``register_fake`` gives its output shapes, so the op walk on meta
  tensors sees one op and allocates nothing;
* its backward takes the saved q, k, v, o and lse by route
  (:func:`bwd_route`, from what it sees, never by a failure): for CUDA
  tensors that ``kernel.bwd_route`` sends to the kernel (bf16/fp16, hd a
  multiple of 8 up to 128), the backward kernel
  (``kernel.flash_attention_bwd``) through the op
  ``repro_torch::flash_attention_bwd``, so that a profiler ties its four
  launches to an op inside the backward's span, as it ties the forward
  kernel to ``repro_torch::flash_attention``; for every other tensor
  (fp32, the O0 parity path, larger hd, CPU and meta) the plain recompute
  — :func:`_ref_gqa` again, differentiated, as the reference's
  ``custom_vjp`` does.  :func:`_ref_flash_bwd` writes the kernel's
  formulas in fp32; the tests hold it to that recompute.  While a
  profiler runs it runs inside the span
  ``repro_torch::flash_attention.bwd`` (:mod:`repro_torch.trace.spans`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.fused.ops import _vjp
from repro_torch.trace.spans import backward_span


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """(B, K, G, Sq, Sk) fp32 scores q·k·hd^-0.5, masked entries -1e30
    (key j visible to query i iff j <= i)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
    return s


def _ref_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    """Reference GQA attention in the model layout (fp32 softmax)."""
    w = torch.softmax(_scores(q, k, causal), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.to(q.dtype)


def _ref_gqa_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_ref_gqa` and each row's log-sum-exp of the scaled, masked
    scores, (B, K, G, Sq) fp32: the op's plain version."""
    s = _scores(q, k, causal)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def _ref_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's formulas in fp32 (the FA2 formulation):
    P = exp(S - lse) with S the scaled, masked scores; D = rowsum(dO ∘ O);
    dV = Pᵀ dO; dP = dO Vᵀ; dS = P ∘ (dP − D); dQ = scale · dS K;
    dK = scale · dSᵀ Q, dK and dV summed over each KV head's G query
    heads.  Returns (dq, dk, dv) in q's, k's and v's dtypes.  No route
    runs it: it is the oracle that ties the kernel's formulas to autograd
    of :func:`_ref_gqa`."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, df = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    d = torch.einsum("bqkgh,bqkgh->bkgq", df, o.float())
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, df)
    dp = torch.einsum("bqkgh,bskh->bkgqs", df, vf)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_route(q: torch.Tensor) -> str:
    """The backward's route for the op's saved q: ``"kernel"`` (CUDA, and
    ``kernel.bwd_route`` takes its hd and dtype), else ``"recompute"``
    (the plain recompute of :func:`_ref_gqa`)."""
    if q.device.type == "cuda" and \
            fk.bwd_route(q.shape[-1], q.dtype) == "kernel":
        return "kernel"
    return "recompute"


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref_gqa_lse(q, k, v, causal)
    return fk.flash_attention_grouped(q, k, v, causal=causal)


@_flash_op.register_fake
def _(q, k, v, causal):
    b, sq, kv, g, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, kv, g, sq),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return fk.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, dout, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, ctx.causal = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, o, lse)


def _flash_bwd(ctx, g, _g_lse):
    q, k, v, o, lse = ctx.saved_tensors
    if bwd_route(q) == "kernel":
        gq, gk, gv = _flash_bwd_op(q, k, v, o, lse, g.contiguous(),
                                   ctx.causal)
    else:
        gq, gk, gv = _vjp(lambda a, b, c: _ref_gqa(a, b, c, ctx.causal),
                          (q, k, v), (g,))
    return gq, gk, gv, None


_flash_op.register_autograd(
    backward_span("repro_torch::flash_attention")(_flash_bwd),
    setup_context=_flash_setup)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q (B, Sq, K, G, hd), k/v (B, Sk, K, hd) → (B, Sq, K, G, hd)."""
    return _flash_op(q.contiguous(), k.contiguous(), v.contiguous(),
                     bool(causal))[0]
