"""The port's LayerNorm (``fused_layernorm`` and its routing) against the
JAX package.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
``layernorm_ref``); on the CPU the wrapper runs ``layernorm_ref``, so this
file holds:

* the port's ``layernorm_apply`` at ``fusion`` ``"off"`` and ``"static"``
  against the reference's ``layernorm_apply`` (its plain route: the
  reference's Pallas kernels do not run on this jax), fp32 and bf16.
  Tolerance: fp32 1e-5 of max|ref| (the same fp32 statistics summed in
  another order); bf16 2^-7 of max|ref| (one rounding at the write of
  fp32 values that may differ in their last bits);
* ``fops.layernorm`` and its gradients against ``jax.vjp`` of the
  reference's ``_ln_ref`` at odd widths, fp32 1e-5 of max|ref|;
* the row whose mean (1e3) is large against its spread (1).  There the
  fp32 statistics of any two summation orders differ by a few ulps of
  |x| ≈ 1e3 (2^-14 ≈ 6.1e-5 each), which the normalization multiplies by
  |scale| / σ: the tolerance is 1e-5 of max|ref| plus 8 such ulps, about
  5e-4 of max|ref| here.  The one-pass form E[x²] − μ² misses by 4–10% of
  max|ref| on these rows (checked below), so the bound still tells the
  two apart;
* the op record's bytes and FLOPs against the module's roofline model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RRunConfig
from repro.kernels.fused import ops as r_ops
from repro.models import layers as r_layers
from repro_torch.configs.base import RunConfig
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.kernels.fused import norm, ops
from repro_torch.models import layers

EPS = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}


def _inputs(shape, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) + mean).astype(np.float32)
    d = shape[-1]
    scale = (1.0 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, scale, bias


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _stat_tol(x: np.ndarray, gain: float, ref: np.ndarray) -> float:
    """1e-5 of max|ref| plus 8 fp32 ulps of max|x| carried through the
    normalization: times ``gain`` (the largest factor applied after it:
    |scale| for the output, |cotangent| for the gradients) over σ of the
    narrowest row."""
    ulp = np.spacing(np.float32(np.abs(x).max()))
    sigma = np.sqrt(x.reshape(-1, x.shape[-1]).var(axis=-1).min())
    return 1e-5 * np.abs(ref).max() + 8 * ulp * gain / sigma


@pytest.mark.parametrize("fusion", ["off", "static"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layernorm_apply_matches_reference(fusion, dtype):
    tdt, jdt, rel = DTYPES[dtype]
    x, scale, bias = _inputs((2, 9, 96), 0)
    r_out = r_layers.layernorm_apply(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x, jdt), EPS, RRunConfig(fusion="off"))
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    out = layers.layernorm_apply(p, torch.from_numpy(x).to(tdt), EPS,
                                 RunConfig(fusion=fusion))
    assert out.dtype == tdt and out.shape == (2, 9, 96)
    ref = _np(r_out)
    np.testing.assert_allclose(_np(out), ref, rtol=0,
                               atol=rel * np.abs(ref).max())
    spec = layers.layernorm_spec(96)
    assert {k: (v.shape, v.init) for k, v in spec.items()} == \
        {k: (v.shape, v.init) for k, v in r_layers.layernorm_spec(96).items()}


@pytest.mark.parametrize("shape", [(3, 7), (5, 1000), (4, 4095), (2, 4096)])
def test_routed_layernorm_and_grads_match_reference(shape):
    x, scale, bias = _inputs(shape, 1)
    gy = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    r_y, vjp = jax.vjp(lambda a, s, b: r_ops._ln_ref(a, s, b, EPS,
                                                     jnp.float32),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    r_grads = vjp(jnp.asarray(gy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = ops.layernorm(*leaves, eps=EPS)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    for got, want in zip((y, *grads), (r_y, *r_grads)):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("d", [7, 1000, 4096])
def test_large_mean_row_keeps_two_pass_precision(d):
    x, scale, bias = _inputs((4, d), 3, mean=1e3)
    want = _np(r_ops._ln_ref(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias), EPS, jnp.float32))
    tol = _stat_tol(x, np.abs(scale).max(), want)
    got = ops.layernorm(*(torch.from_numpy(a) for a in (x, scale, bias)),
                        eps=EPS)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)
    assert tol < 1e-3 * np.abs(want).max()
    # the one-pass variance E[x²] − μ² cancels on these rows
    xf = torch.from_numpy(x)
    mu = xf.mean(-1, keepdim=True)
    one_pass = (xf * xf).mean(-1, keepdim=True) - mu * mu
    naive = ((xf - mu) * torch.rsqrt(one_pass + EPS) * torch.from_numpy(scale)
             + torch.from_numpy(bias))
    assert np.abs(_np(naive) - want).max() > 10 * tol


def test_large_mean_row_gradients():
    x, scale, bias = _inputs((4, 1000), 4, mean=1e3)
    gy = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, b: r_ops._ln_ref(a, s, b, EPS, jnp.float32),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    grads = torch.autograd.grad(ops.layernorm(*leaves, eps=EPS), leaves,
                                torch.from_numpy(gy))
    for got, want in zip(grads, vjp(jnp.asarray(gy))):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=_stat_tol(x, np.abs(gy).max(), want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wrapper_takes_plain_path_on_cpu(dtype):
    tdt = DTYPES[dtype][0]
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((33, 100), 6))
    x = x.to(tdt)
    for out_dtype in (tdt, torch.float32):
        got = norm.fused_layernorm(x, scale.to(tdt), bias, eps=EPS,
                                   out_dtype=out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, norm.layernorm_ref(x, scale.to(tdt), bias,
                                                   EPS, out_dtype))
    with pytest.raises(ValueError, match="bias shape"):
        norm.fused_layernorm(x, scale, bias[:9])


@pytest.mark.parametrize("rows,d,dtype", [(4096, 4096, torch.bfloat16),
                                          (33, 100, torch.float32)])
def test_op_record_matches_the_module_model(rows, d, dtype):
    x = torch.empty(rows, d, dtype=dtype, device="meta")
    s = torch.empty(d, device="meta")
    (rec,) = analyze_fn(lambda a, b, c: ops.layernorm(a, b, c),
                        (x, s, s)).kernels
    assert rec.opcode == "layernorm" and rec.category == "custom"
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert rec.hbm_bytes == norm.hbm_bytes(rows, d, itemsize, bias=True)
    assert rec.flops == norm.layernorm_flops(rows, d)
    # the reference's model leaves the bias out
    from repro.kernels.fused import norm as r_norm
    assert norm.hbm_bytes(rows, d, itemsize, bias=True) == \
        r_norm.hbm_bytes(rows, d, itemsize) + 4 * d
