"""Fused RMSNorm, residual RMSNorm and LayerNorm (port of
``repro.kernels.fused.norm``).

One pass does what the unfused chain spreads over an upcast, the
statistics, the normalization, the affine terms and a downcast (and,
before it, the residual add)::

    r = x + h                     (residual variant; rounded to x's dtype)
    y = r · rsqrt(mean(r²) + eps) · scale     (rmsnorm; statistics in fp32)
    y = (x − μ) · rsqrt(var + eps) · scale + bias   (layernorm; population
                                                     variance, fp32)
    out = y.astype(out_dtype)     (one rounding at the write)

On a CUDA tensor :func:`fused_rmsnorm`, :func:`fused_rmsnorm_residual`
and :func:`fused_layernorm` launch the hand-written kernels in
``csrc/fused.cu``; on a CPU tensor they run the plain versions
:func:`rmsnorm_ref`, :func:`rmsnorm_residual_ref` and
:func:`layernorm_ref`, which repeat the reference's math op for op.
``hbm_bytes`` and ``flops`` are each kernel's roofline model.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.fused import common

#: the longest row the layernorm kernel takes (d fp32 values of shared
#: memory; the reference's NORM_D_MAX)
D_MAX = 16_384

#: launches of the CUDA kernels (the plain CPU path does not count)
LAUNCHES = 0
RESIDUAL_LAUNCHES = 0
LAYERNORM_LAUNCHES = 0


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version (the reference's ``_rms_ref``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(out_dtype)


def rmsnorm_residual_ref(x: torch.Tensor, h: torch.Tensor,
                         scale: torch.Tensor, eps: float,
                         out_dtype: torch.dtype
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``r = x + h`` in x's dtype, then the rmsnorm of that
    rounded ``r``."""
    r = x + h
    return r, rmsnorm_ref(r, scale, eps, out_dtype)


def layernorm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version (the reference's ``_ln_ref``): the population
    variance (``jnp.var``; ``torch.var`` would default to
    ``correction=1``)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(out_dtype)


def _operands(x: torch.Tensor, scale: torch.Tensor,
              h: torch.Tensor | None = None) -> tuple[int, int]:
    rows, d = common.rows_view(x)
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if h is not None and (h.shape != x.shape or h.dtype != x.dtype):
        raise ValueError(f"residual operand {tuple(h.shape)}/{h.dtype} "
                         f"differs from x {tuple(x.shape)}/{x.dtype}")
    return rows, d


def _launch(x, h, scale, r, y, eps: float, cfg: kc.KernelConfig,
            what: str) -> None:
    rows, d = x.shape
    blocks, threads = common.row_grid(rows, d, cfg, x)
    lib = build.load("fused")
    err = lib.fused_rmsnorm(
        x.data_ptr(), None if h is None else h.data_ptr(), scale.data_ptr(),
        None if r is None else r.data_ptr(), y.data_ptr(), rows, d,
        float(eps), common.code(x), common.code(scale), common.code(y),
        blocks, threads, build.stream_of(x))
    build.check(lib, err, what)


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
                  out_dtype: torch.dtype | None = None,
                  config: kc.KernelConfig | None = None) -> torch.Tensor:
    """x (rows, d), scale (d,) → rmsnorm(x)·scale as ``out_dtype``.

    Any rows and d; x, scale and the output may each be f32 or bf16, and
    ``scale`` may be a view at any offset (a layer of a stacked param).
    """
    global LAUNCHES
    out_dtype = out_dtype or x.dtype
    rows, d = _operands(x, scale)
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, out_dtype)
    cfg = kc.for_launch("fused_norm", config, x, (rows, d))
    build.require_cuda(x, scale, align=1)
    y = torch.empty((rows, d), dtype=out_dtype, device=x.device)
    if rows == 0:
        return y
    _launch(x, None, scale, None, y, eps, cfg, "fused_rmsnorm")
    LAUNCHES += 1
    return y


def fused_rmsnorm_residual(x: torch.Tensor, h: torch.Tensor,
                           scale: torch.Tensor, *, eps: float = 1e-5,
                           out_dtype: torch.dtype | None = None,
                           config: kc.KernelConfig | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + h, rmsnorm(x + h)·scale) in one pass; x/h (rows, d), one
    dtype.  ``r`` has x's dtype, ``y`` ``out_dtype``."""
    global RESIDUAL_LAUNCHES
    out_dtype = out_dtype or x.dtype
    rows, d = _operands(x, scale, h)
    if all(t.device.type == "cpu" for t in (x, h, scale)):
        return rmsnorm_residual_ref(x, h, scale, eps, out_dtype)
    cfg = kc.for_launch("fused_norm", config, x, (rows, d))
    build.require_cuda(x, h, scale, align=1)
    r = torch.empty_like(x)
    y = torch.empty((rows, d), dtype=out_dtype, device=x.device)
    if rows == 0:
        return r, y
    _launch(x, h, scale, r, y, eps, cfg, "fused_rmsnorm_residual")
    RESIDUAL_LAUNCHES += 1
    return r, y


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, eps: float = 1e-5,
                    out_dtype: torch.dtype | None = None,
                    config: kc.KernelConfig | None = None) -> torch.Tensor:
    """x (rows, d), scale/bias (d,) → layernorm(x)·scale + bias as
    ``out_dtype``.

    Any rows and d up to :data:`D_MAX` (the kernel keeps a row in shared
    memory); x and the output f32 or bf16; scale and bias each f32 or
    bf16, views at any offset.
    """
    global LAYERNORM_LAUNCHES
    out_dtype = out_dtype or x.dtype
    rows, d = _operands(x, scale)
    if tuple(bias.shape) != (d,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({d},)")
    if all(t.device.type == "cpu" for t in (x, scale, bias)):
        return layernorm_ref(x, scale, bias, eps, out_dtype)
    if d > D_MAX:
        raise ValueError(f"fused_layernorm takes rows of at most {D_MAX}, "
                         f"got d={d}")
    cfg = kc.for_launch("fused_norm", config, x, (rows, d))
    build.require_cuda(x, scale, bias, align=1)
    y = torch.empty((rows, d), dtype=out_dtype, device=x.device)
    if rows == 0:
        return y
    blocks, threads = common.row_grid(rows, d, cfg, x)
    lib = build.load("fused")
    err = lib.fused_layernorm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows,
        d, float(eps), common.code(x), common.code(scale), common.code(bias),
        common.code(y), blocks, threads, build.stream_of(x))
    build.check(lib, err, "fused_layernorm")
    LAYERNORM_LAUNCHES += 1
    return y


def hbm_bytes(rows: int, d: int, itemsize: int = 2,
              residual: bool = False, bias: bool = False) -> float:
    """Fused traffic: x (+h) in, y (+r) out, an f32 scale once (the
    reference's formula; one dtype for every row stream), and for the
    layernorm (``bias=True``) an f32 bias once, which the reference's
    formula leaves out."""
    n_streams = 4 if residual else 2
    return float(n_streams * rows * d * itemsize + (8 if bias else 4) * d)


def flops(rows: int, d: int, residual: bool = False) -> float:
    """Operations of the plain rmsnorm math, counted as the op walk counts
    them: per element a square, a sum, two multiplies (and the residual
    add); per row the mean's divide, the eps add and the rsqrt."""
    return float((5 if residual else 4) * rows * d + 3 * rows)


def layernorm_flops(rows: int, d: int) -> float:
    """Operations of the plain layernorm math: per element the mean's sum,
    the centring subtract, a square and a sum for the variance, the
    normalizing multiply, the scale multiply and the bias add; per row
    the two divides, the eps add and the rsqrt."""
    return float(7 * rows * d + 4 * rows)
