"""Model-facing routing for the fused kernels (port of
``repro.kernels.fused.ops``): eligibility, and one PyTorch op per routed
function.

``RunConfig.fusion = "static"`` routes the memory-bound chains the zero-AI
census ranks hottest through the kernels of this package.  The
eligibility predicates are hard correctness gates with the reference's
limits: anything the kernels cannot take (other dtypes, degenerate
shapes, oversized rows) keeps the plain math at the call site, with the
same outputs.  Under ``"static"`` eligibility alone routes to the kernel;
under ``"auto"`` (alias ``"measured"``) each eligible site also asks the
measured dispatch table (:func:`repro_torch.tune.dispatch.decide`), so
only sites whose fused timing beat the plain chain run fused.  The call
sites ask the ``use_*`` helpers below.

Each routed function is one op in the ``repro_torch::`` namespace
(``torch.library.custom_op``):

* its implementation calls the kernel module's wrapper, which launches
  the CUDA kernel for a CUDA tensor (or raises) and runs the plain
  version for a CPU tensor;
* ``register_fake`` gives its output shapes, so the op walk on meta
  tensors sees one op and allocates nothing;
* ``register_autograd`` gives a backward that recomputes the plain math
  and differentiates it — the reference's ``custom_vjp`` backwards do
  the same (recompute, not store).  The recompute stops short of the
  final cast to the output dtype and takes the cotangent in fp32
  instead: the cast's vjp is exactly that upcast, so the gradients are
  the same and the backward launches one cast fewer.

Also here: :func:`embed_with_onehot_grad`, the embedding gather whose
backward is one ``onehot(tokens)ᵀ @ g`` matmul instead of a scatter; its
eligibility caps the transient one-hot at :data:`ONEHOT_BYTES_MAX`.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.kernels.fused import adamw as ak
from repro_torch.kernels.fused import norm as nk
from repro_torch.kernels.fused import swiglu as sk

_FLOAT_DTYPES = (torch.float32, torch.bfloat16)

# the feature dim of a row the norm kernels take (the reference's limit:
# one VMEM-resident row block); rows are unbounded
NORM_D_MAX = 16_384
SWIGLU_D_MAX = 32_768
# transient one-hot budget for the scatter-free embedding backward
ONEHOT_BYTES_MAX = 2 ** 28
# the flash-from-chunked route needs a non-degenerate q/k block
FLASH_MIN_BLOCK = 16

#: modes that route through this package at all / that consult the
#: measured dispatch table instead of trusting eligibility
_ENABLED_MODES = ("static", "auto", "measured")
_MEASURED_MODES = ("auto", "measured")


def fusion_enabled(run) -> bool:
    """The routing predicate every call site guards on."""
    return run is not None and getattr(run, "fusion", "off") in _ENABLED_MODES


def fusion_measured(run) -> bool:
    """Does this run route by measured winners (``auto`` / ``measured``)
    rather than by eligibility alone (``static``)?"""
    return (run is not None
            and getattr(run, "fusion", "off") in _MEASURED_MODES)


def _dispatch_fused(run, key: Callable, device) -> bool:
    """The verdict of an eligible site: ``static`` takes the kernel; the
    measured modes ask the dispatch table for ``key()`` (built only
    then), which measures on ``device``, or raises, on a miss as
    ``REPRO_DISPATCH`` says."""
    if not fusion_measured(run):
        return True
    from repro_torch.tune import dispatch as dsp
    return dsp.decide(key(), device=device) == "fused"


# --------------------------------------------------------------------------
# use_* — the one question each call site asks: eligibility (the hard
# correctness gate) and then the dispatch verdict
# --------------------------------------------------------------------------

def use_norm(run, x, scale, bias=None, *, kind: str = "rmsnorm",
             out_dtype=None) -> bool:
    if not (fusion_enabled(run) and norm_eligible(x, scale, bias)):
        return False
    from repro_torch.tune import dispatch as dsp
    return _dispatch_fused(run, lambda: dsp.norm_key(
        x, scale, bias, kind=kind, out_dtype=out_dtype), x.device)


def use_swiglu(run, gate, up, *, act: str = "silu", out_dtype=None) -> bool:
    if not (fusion_enabled(run) and swiglu_eligible(gate, up)):
        return False
    from repro_torch.tune import dispatch as dsp
    return _dispatch_fused(run, lambda: dsp.swiglu_key(
        gate, up, act=act, out_dtype=out_dtype), gate.device)


def use_adamw(run, g, m, v, p) -> bool:
    """Eligibility of one leaf (asked once per leaf of the tree, DeepCAM:
    370 an opt call): under ``static`` the answer; under the measured
    modes the verdict is its dtype group's (:func:`adamw_routes`)."""
    return fusion_enabled(run) and adamw_eligible(g, m, v, p)


def adamw_routes(run, leaves: Sequence[tuple]) -> list[int]:
    """Indices of the (g, m, v, p) ``leaves`` that take the kernel.

    Under ``static`` every eligible leaf.  Under the measured modes each
    eligible leaf's site is still asked as the reference asks it (its
    key; measured, or refused, on a miss as ``REPRO_DISPATCH`` says), but
    the verdict is its dtype group's, the one launch the kernel makes:
    the group's leaves take the kernel together when the sum of their
    measured fused walls is at most the sum of their plain-chain walls
    (a site with no record, the ``static`` miss policy, counts as
    neither).  Each leaf's site times a launch of its own, where in the
    group it costs one table row: routed alone, a small leaf at a near
    tie could leave the group for a chain of about ten launches."""
    elig = [i for i, leaf in enumerate(leaves) if use_adamw(run, *leaf)]
    if not (elig and fusion_measured(run)):
        return elig
    from repro_torch.tune import dispatch as dsp
    out = []
    for idx in ak.groups(*([leaves[i][k] for i in elig]
                           for k in range(4))).values():
        fused = ref = 0.0
        for j in idx:
            _, m, _, p = leaves[elig[j]]
            walls = dsp.site_walls(dsp.adamw_key(p, m), device=p.device)
            if walls is not None:
                fused, ref = fused + walls[0], ref + walls[1]
        if fused <= ref:
            out += [elig[j] for j in idx]
    return sorted(out)


def use_embed(run, table, tokens, compute_dtype) -> bool:
    if not (fusion_enabled(run)
            and embed_grad_eligible(tokens, int(table.shape[0]))):
        return False
    from repro_torch.tune import dispatch as dsp
    return _dispatch_fused(run, lambda: dsp.embed_key(
        table, tokens, compute_dtype), table.device)


def use_flash_from_chunked(run, q_shape, k_shape, dtype, *, causal: bool,
                           has_memory: bool, has_cache: bool,
                           softmax_f32: bool, chunk: int,
                           device: torch.device | None = None) -> bool:
    """May ``attn_impl="chunked"`` take the flash kernel at this call?
    Never for cross-attention (``has_memory``) or against a KV cache
    (``has_cache``): the kernel is causal self-attention."""
    if not (fusion_enabled(run) and flash_from_chunked_eligible(
            int(q_shape[1]), int(k_shape[1]), causal=causal,
            has_memory=has_memory, has_cache=has_cache,
            softmax_f32=softmax_f32)):
        return False
    from repro_torch.tune import dispatch as dsp
    return _dispatch_fused(run, lambda: dsp.flash_key(
        q_shape, k_shape, dtype, chunk=chunk, device=device), device)


# --------------------------------------------------------------------------
# Eligibility rules (the reference's, on torch tensors)
# --------------------------------------------------------------------------

def _floaty(*ts) -> bool:
    return all(t.dtype in _FLOAT_DTYPES for t in ts)


def norm_eligible(x, scale, bias=None) -> bool:
    """2D+ float32/bf16 activations with a matching 1D scale (and bias)."""
    if x.ndim < 2 or x.shape[-1] == 0 or x.shape[-1] > NORM_D_MAX:
        return False
    if tuple(scale.shape) != (x.shape[-1],):
        return False
    if bias is not None and bias.shape != scale.shape:
        return False
    return _floaty(x)


def swiglu_eligible(gate, up) -> bool:
    if gate.ndim < 2 or gate.shape != up.shape:
        return False
    if gate.shape[-1] == 0 or gate.shape[-1] > SWIGLU_D_MAX:
        return False
    return _floaty(gate, up)


def adamw_eligible(g, m, v, p) -> bool:
    """Same-shaped float leaves; anything else keeps the plain chain."""
    if not (g.shape == m.shape == v.shape == p.shape) or p.numel() == 0:
        return False
    return _floaty(g, m, v, p)


def embed_grad_eligible(tokens, vocab: int) -> bool:
    """Cap the transient (B·S, V) one-hot the matmul backward builds."""
    return 0 < tokens.numel() * vocab * 4 <= ONEHOT_BYTES_MAX


def flash_from_chunked_eligible(sq: int, sk_: int, *, causal: bool,
                                has_memory: bool, has_cache: bool,
                                softmax_f32: bool) -> bool:
    """May the chunked path route to the flash kernel?

    The kernel is causal self-attention with fp32 online-softmax
    statistics.  The reference also wants its largest block that divides
    the sequence non-degenerate (a prime-length 17-token sequence would
    run 1-wide TPU blocks); the rule is kept on the reference's blocks,
    so both packages route the same shapes, although the Hopper kernel
    masks a ragged tile and takes any length.
    """
    if has_memory or has_cache or not causal or not softmax_f32:
        return False
    if sq != sk_:
        return False

    def fit(block: int, dim: int) -> int:
        block = min(block, dim)
        while block > 1 and dim % block:
            block //= 2
        return block

    from repro_torch.kernels.flash_attention.kernel import (DEFAULT_BLOCK_K,
                                                            DEFAULT_BLOCK_Q)
    return (fit(DEFAULT_BLOCK_Q, sq) >= FLASH_MIN_BLOCK
            and fit(DEFAULT_BLOCK_K, sk_) >= FLASH_MIN_BLOCK)


# --------------------------------------------------------------------------
# Backward by recomputation
# --------------------------------------------------------------------------

def _vjp(fn: Callable, primals: Sequence[torch.Tensor],
         cotangents: Sequence[torch.Tensor | None]) -> tuple:
    """Gradients of ``fn(*primals)`` (a tensor or a tuple) against
    ``cotangents``, by running ``fn`` again under autograd."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in primals]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        return torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [c for _, c in pairs], allow_unused=True)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor, eps: float,
                out_dtype: torch.dtype) -> torch.Tensor:
    return nk.fused_rmsnorm(x, scale, eps=eps, out_dtype=out_dtype)


@_rmsnorm_op.register_fake
def _(x, scale, eps, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


def _rmsnorm_setup(ctx, inputs, output):
    x, scale, ctx.eps, _ = inputs
    ctx.save_for_backward(x, scale)


def _rmsnorm_bwd(ctx, gy):
    x, scale = ctx.saved_tensors
    gx, gs = _vjp(lambda a, s: nk.rmsnorm_ref(a, s, ctx.eps, torch.float32),
                  (x, scale), (gy.float(),))
    return gx, gs, None, None


_rmsnorm_op.register_autograd(_rmsnorm_bwd, setup_context=_rmsnorm_setup)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Routed fused RMSNorm on any (..., d) activation."""
    d = x.shape[-1]
    y = _rmsnorm_op(x.reshape(-1, d), scale, float(eps),
                    out_dtype or x.dtype)
    return y.reshape(x.shape)


@torch.library.custom_op("repro_torch::rmsnorm_residual", mutates_args=())
def _rmsnorm_residual_op(x: torch.Tensor, h: torch.Tensor,
                         scale: torch.Tensor, eps: float,
                         out_dtype: torch.dtype
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    return nk.fused_rmsnorm_residual(x, h, scale, eps=eps,
                                     out_dtype=out_dtype)


@_rmsnorm_residual_op.register_fake
def _(x, h, scale, eps, out_dtype):
    return torch.empty_like(x), x.new_empty(x.shape, dtype=out_dtype)


def _rmsnorm_residual_setup(ctx, inputs, output):
    x, h, scale, ctx.eps, _ = inputs
    ctx.save_for_backward(x, h, scale)


def _rmsnorm_residual_bwd(ctx, gr, gy):
    gx, gh, gs = _vjp(
        lambda a, b, s: nk.rmsnorm_residual_ref(a, b, s, ctx.eps,
                                                torch.float32),
        ctx.saved_tensors, (gr, gy.float()))
    return gx, gh, gs, None, None


_rmsnorm_residual_op.register_autograd(
    _rmsnorm_residual_bwd, setup_context=_rmsnorm_residual_setup)


def rmsnorm_residual(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                     *, eps: float = 1e-5,
                     out_dtype: torch.dtype | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed fused (x + h, rmsnorm(x + h)·scale) on (..., d) streams."""
    d = x.shape[-1]
    r, y = _rmsnorm_residual_op(x.reshape(-1, d), h.reshape(-1, d), scale,
                                float(eps), out_dtype or x.dtype)
    return r.reshape(x.shape), y.reshape(x.shape)


@torch.library.custom_op("repro_torch::layernorm", mutates_args=())
def _layernorm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    return nk.fused_layernorm(x, scale, bias, eps=eps, out_dtype=out_dtype)


@_layernorm_op.register_fake
def _(x, scale, bias, eps, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


def _layernorm_setup(ctx, inputs, output):
    x, scale, bias, ctx.eps, _ = inputs
    ctx.save_for_backward(x, scale, bias)


def _layernorm_bwd(ctx, gy):
    gx, gs, gb = _vjp(
        lambda a, s, b: nk.layernorm_ref(a, s, b, ctx.eps, torch.float32),
        ctx.saved_tensors, (gy.float(),))
    return gx, gs, gb, None, None


_layernorm_op.register_autograd(_layernorm_bwd,
                                setup_context=_layernorm_setup)


#: the plain layernorm under the reference's name for it
_ln_ref = nk.layernorm_ref


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Routed fused LayerNorm on any (..., d) activation."""
    d = x.shape[-1]
    y = _layernorm_op(x.reshape(-1, d), scale, bias, float(eps),
                      out_dtype or x.dtype)
    return y.reshape(x.shape)


# --------------------------------------------------------------------------
# SwiGLU / GeGLU epilogue
# --------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::swiglu", mutates_args=())
def _swiglu_op(gate: torch.Tensor, up: torch.Tensor, act: str,
               out_dtype: torch.dtype) -> torch.Tensor:
    return sk.fused_swiglu(gate, up, act=act, out_dtype=out_dtype)


@_swiglu_op.register_fake
def _(gate, up, act, out_dtype):
    return gate.new_empty(gate.shape, dtype=out_dtype)


def _swiglu_setup(ctx, inputs, output):
    gate, up, ctx.act, _ = inputs
    ctx.save_for_backward(gate, up)


def _swiglu_bwd(ctx, gy):
    gg, gu = _vjp(lambda a, b: sk.swiglu_ref(a, b, ctx.act, torch.float32),
                  ctx.saved_tensors, (gy.float(),))
    return gg, gu, None, None


_swiglu_op.register_autograd(_swiglu_bwd, setup_context=_swiglu_setup)


def swiglu(gate: torch.Tensor, up: torch.Tensor, *, act: str = "silu",
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Routed fused act(gate)·up on (..., d_ff) activations."""
    d = gate.shape[-1]
    y = _swiglu_op(gate.reshape(-1, d), up.reshape(-1, d), act,
                   out_dtype or gate.dtype)
    return y.reshape(gate.shape)


# --------------------------------------------------------------------------
# AdamW (no grad path — the optimizer is not differentiated)
# --------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::adamw_multi_",
                         mutates_args=("ms", "vs", "ps"))
def _adamw_multi_op(gs: list[torch.Tensor], ms: list[torch.Tensor],
                    vs: list[torch.Tensor], ps: list[torch.Tensor],
                    bc: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float, weight_decay: float) -> None:
    ak.fused_adamw_multi(gs, ms, vs, ps, bc, lr=lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, inplace=True)


@_adamw_multi_op.register_fake
def _(gs, ms, vs, ps, bc, lr, b1, b2, eps, weight_decay):
    return None


@torch.library.custom_op("repro_torch::adamw_multi", mutates_args=())
def _adamw_multi_fn(gs: list[torch.Tensor], ms: list[torch.Tensor],
                    vs: list[torch.Tensor], ps: list[torch.Tensor],
                    bc: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float, weight_decay: float) -> list[torch.Tensor]:
    """ps′ + ms′ + vs′ in one list: the kernel writes them through its
    output pointers."""
    po, mo, vo = ak.fused_adamw_multi(gs, ms, vs, ps, bc, lr=lr, b1=b1,
                                      b2=b2, eps=eps,
                                      weight_decay=weight_decay)
    return [*po, *mo, *vo]


@_adamw_multi_fn.register_fake
def _(gs, ms, vs, ps, bc, lr, b1, b2, eps, weight_decay):
    return [torch.empty_like(t) for ts in (ps, ms, vs) for t in ts]


def adamw_group(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor],
                bc: torch.Tensor, *, lr: float, b1: float, b2: float,
                eps: float, weight_decay: float, inplace: bool = False
                ) -> tuple[list[torch.Tensor], list[torch.Tensor],
                           list[torch.Tensor]]:
    """Routed fused AdamW update of a list of leaves → (ps′, ms′, vs′):
    one ``repro_torch::adamw_multi_`` call (``inplace=True``: written
    over ps, ms, vs, which it returns) or ``repro_torch::adamw_multi``
    (new tensors), one kernel launch per dtype group of the leaves;
    ``bc`` is the (2,) fp32 tensor of bias corrections.  The kernel reads
    the leaves flat, and a gradient may come back strided (a tied
    embedding's is a gather's plus a transpose's), so each g is made
    contiguous first.  Under :func:`tune.dispatch.step_points` it notes
    the tuned-config lookups the kernel's launches make."""
    from repro_torch.tune import dispatch as dsp
    args = ([g.contiguous() for g in gs], list(ms), list(vs), list(ps), bc,
            float(lr), float(b1), float(b2), float(eps), float(weight_decay))
    dsp.note_points(lambda: ak.tune_points(*args[:4]))
    if inplace:
        _adamw_multi_op(*args)
        return args[3], args[1], args[2]
    out = _adamw_multi_fn(*args)
    k = len(args[3])
    return out[:k], out[k:2 * k], out[2 * k:]


# --------------------------------------------------------------------------
# Op walk: FLOPs (and, for flash attention, bytes) of each routed op
# (core/op_analysis.py reads these)
# --------------------------------------------------------------------------

def _ssd_dims(args: Sequence) -> tuple[int, int, int, int, int, int]:
    """(B, H, S, P, N, chunk) of a ``repro_torch::ssd_scan`` call."""
    b, s, h, p = args[0].shape
    return b, h, s, p, int(args[2].shape[-1]), int(args[4])


def _flash_dims(args: Sequence) -> tuple[int, int, int, int]:
    """(B·H, Sq, Sk, hd) of a ``repro_torch::flash_attention`` call."""
    b, sq, kv, g, hd = args[0].shape
    return b * kv * g, sq, int(args[1].shape[1]), hd


def op_flops(name: str, args: Sequence) -> float:
    """FLOPs of one call of the ``repro_torch::<name>`` op, from the
    kernel module's count."""
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import kernel as fk
        return fk.flops(*_flash_dims(args), causal=bool(args[3]))
    if name in ("rmsnorm", "rmsnorm_residual"):
        rows, d = args[0].shape
        return nk.flops(rows, d, residual=name == "rmsnorm_residual")
    if name == "layernorm":
        return nk.layernorm_flops(*args[0].shape)
    if name == "swiglu":
        rows, d = args[0].shape
        return sk.flops(rows, d, args[2])
    if name in ("adamw_multi_", "adamw_multi"):
        return ak.flops(sum(p.numel() for p in args[3]))
    if name == "ssd_scan":
        from repro_torch.kernels.ssd_scan import kernel as ssd
        return ssd.flops(*_ssd_dims(args))
    raise KeyError(f"no FLOP rule for repro_torch::{name}")


def op_bytes(name: str, args: Sequence) -> float | None:
    """Device-memory bytes of one call where the kernel module's model is
    not operands + results: flash attention's ``hbm_bytes``, which counts
    K/V once per *query* head as the reference's does; and the AdamW
    group's sum over its leaves of what a one-leaf call moves — g, m, v
    and p read, p, m and v written, each in its own dtype, and the
    8-byte ``bc`` once per leaf, as the one ``pallas_call`` per leaf it
    replaces reads it (``adamw.hbm_bytes(n)`` a leaf in fp32), so the
    group's record equals the per-leaf records it stands for.  ``None``:
    the op walk's own rule (for ``ssd_scan`` that rule equals the
    module's ``hbm_bytes``: B and C are operands once per batch, not per
    head)."""
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import kernel as fk
        return fk.hbm_bytes(*_flash_dims(args), args[0].element_size())
    if name in ("adamw_multi_", "adamw_multi"):
        gs, ms, vs, ps, bc = args[:5]
        return float(sum(
            g.numel() * g.element_size()
            + 2 * p.numel() * (m.element_size() + v.element_size()
                               + p.element_size())
            for g, m, v, p in zip(gs, ms, vs, ps))
            + len(ps) * bc.numel() * bc.element_size())
    return None


# --------------------------------------------------------------------------
# Scatter-free embedding backward
# --------------------------------------------------------------------------

class _EmbedOneHot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens, compute_dtype):
        ctx.save_for_backward(tokens)
        ctx.vocab, ctx.table_dtype = int(table.shape[0]), table.dtype
        return table.to(compute_dtype)[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        cols = torch.arange(ctx.vocab, device=tokens.device)
        oh = (tokens.reshape(-1)[:, None] == cols).float()
        gt = oh.T @ g.reshape(-1, g.shape[-1]).float()
        return gt.to(ctx.table_dtype), None, None


def embed_with_onehot_grad(table: torch.Tensor, tokens: torch.Tensor,
                           compute_dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather whose backward is one ``onehotᵀ @ g`` matmul.

    The forward is exactly ``table.to(compute_dtype)[tokens]``; only the
    gradient changes (a matmul instead of an index scatter), equal up to
    the fp32 summation order."""
    return _EmbedOneHot.apply(table, tokens, compute_dtype)
