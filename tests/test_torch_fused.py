"""The port's fused kernels and their routing against the JAX package.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each one
against the plain versions tested here).  On the CPU every wrapper runs
its plain version, and the routed ops are real ``repro_torch::`` ops, so
this file holds:

* each plain version against the reference's math (``fops._rms_ref``, the
  residual ``ref``, ``jax.nn.silu`` / ``jax.nn.gelu`` · up, the fused AdamW
  leaf math of ``optim.adamw_update``) in f32 and bf16, at odd rows and
  odd ``d``.  Tolerance: f32 rtol 1e-6 with atol 1e-6 (the same fp32 ops;
  XLA and ATen may differ by an ulp in rsqrt, exp or tanh); bf16 one bf16
  ulp of the value (at most 2^-7 relative), since both round once at the
  write from fp32 values that may differ by an ulp.  The tanh gelu also
  gets an absolute floor of 1e-6 of max|gate·up| (1e-5 of the largest
  gradient): for a negative gate ``1 + tanh(..)`` cancels, and XLA's and
  ATen's tanh differ by an ulp near -1;
* the gradients of the routed ops against ``jax.vjp`` of the same
  references: f32 rtol 1e-5 (fp32 sums in another order); bf16 inputs
  compared within 2^-7 of the largest gradient (the cotangent of a bf16
  output is rounded at different places);
* the eligibility verdicts against ``repro.kernels.fused.ops``;
* the fake implementations on meta tensors, the op walk's custom rule,
  and the phase census at ``off`` and ``static``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused import adamw as r_adamw
from repro.kernels.fused import norm as r_norm
from repro.kernels.fused import ops as r_ops
from repro.kernels.fused import swiglu as r_swiglu
from repro_torch import kernels
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.kernels import build
from repro_torch.kernels.fused import adamw, norm, ops, swiglu
from repro_torch.session.session import Session

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# odd rows and odd d, one row, one column
SHAPES = [(1, 64), (7, 1), (33, 100), (257, 96), (5, 4097)]

SMOKE = {"off": (37_748_736, 113_246_208, 0),
         # + the one-hot embedding gradient 2·(4·32)·512·64 in bwd
         "static": (37_748_736, 121_634_816, 0)}


def _pair(arr: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(arr).to(tdt), jnp.asarray(arr, dtype=jdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(t, j, dtype: str, atol: float = 0.0) -> None:
    a, b = _f32(t), _f32(j)
    if dtype == "f32":
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=max(atol, 1e-6))
    else:
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=max(atol, 1e-30))


def _rand(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# plain versions against the reference's math
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_rmsnorm_plain_matches_reference(shape, dtype):
    x_t, x_j = _pair(_rand(shape, 0, 3.0), dtype)
    s = np.random.default_rng(1).uniform(0.5, 1.5, shape[1]).astype(
        np.float32)
    want = r_ops._rms_ref(x_j, jnp.asarray(s), 1e-5, DTYPES[dtype][1])
    got = norm.fused_rmsnorm(x_t, torch.from_numpy(s), eps=1e-5)
    assert got.dtype == DTYPES[dtype][0]
    _close(got, want, dtype)
    assert norm.rmsnorm_ref(x_t, torch.from_numpy(s), 1e-5,
                            torch.float32).dtype == torch.float32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_rmsnorm_residual_plain_matches_reference(shape, dtype):
    x_t, x_j = _pair(_rand(shape, 2), dtype)
    h_t, h_j = _pair(_rand(shape, 3), dtype)
    s = jnp.full((shape[1],), 1.3, jnp.float32)
    r_j = x_j + h_j                      # the reference's ref: r in x's dtype
    y_j = r_ops._rms_ref(r_j, s, 1e-5, DTYPES[dtype][1])
    r_t, y_t = norm.fused_rmsnorm_residual(x_t, h_t,
                                           torch.full((shape[1],), 1.3))
    np.testing.assert_array_equal(_f32(r_t), _f32(r_j))
    _close(y_t, y_j, dtype)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 64), (33, 100), (5, 4097)])
def test_swiglu_plain_matches_reference(shape, dtype, act):
    g_t, g_j = _pair(_rand(shape, 4, 2.0), dtype)
    u_t, u_j = _pair(_rand(shape, 5), dtype)
    gf = g_j.astype(jnp.float32)
    h = jax.nn.silu(gf) if act == "silu" else jax.nn.gelu(gf)
    want = (h * u_j.astype(jnp.float32)).astype(DTYPES[dtype][1])
    got = swiglu.fused_swiglu(g_t, u_t, act=act)
    assert got.dtype == DTYPES[dtype][0]
    floor = 1e-6 * float(np.abs(_f32(g_j) * _f32(u_j)).max())
    _close(got, want, dtype, atol=floor if act == "gelu" else 0.0)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-6, 6, 1001)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(swiglu.gelu_tanh(x).numpy(), want, rtol=1e-6,
                               atol=1e-6)
    exact = torch.nn.functional.gelu(x)
    assert float((swiglu.gelu_tanh(x) - exact).abs().max()) > 1e-4


def test_unknown_activation_raises():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="unknown activation"):
        swiglu.fused_swiglu(x, x, act="relu")
    with pytest.raises(ValueError, match="unknown activation"):
        swiglu.flops(2, 4, "relu")


@pytest.mark.parametrize("dtypes", [("f32", "f32", "f32"),
                                    ("f32", "bf16", "bf16"),
                                    ("bf16", "bf16", "bf16"),
                                    ("bf16", "f32", "f32")])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_adamw_plain_matches_reference(n, dtypes):
    """g / (m, v) / p dtypes as the train step's: O1, O2 after unscaling,
    O2's raw bf16 grads, and bf16 grads on fp32 state."""
    g_dt, m_dt, p_dt = dtypes
    g_t, g_j = _pair(_rand((n,), 6), g_dt)
    m_t, m_j = _pair(_rand((n,), 7, 0.1), m_dt)
    v_t, v_j = _pair(np.abs(_rand((n,), 8, 0.01)), m_dt)
    p_t, p_j = _pair(_rand((n,), 9), p_dt)
    count = jnp.asarray(4, jnp.int32)
    r_p, r_s = _r_adamw_update(g_j, m_j, v_j, p_j, count)
    bc = torch.tensor([1 - 0.9 ** 5, 1 - 0.95 ** 5], dtype=torch.float32)
    got = adamw.fused_adamw(g_t, m_t, v_t, p_t, bc)
    for t, w, dt in zip(got, (r_p, r_s.mu["w"], r_s.nu["w"]),
                        (p_dt, m_dt, m_dt)):
        assert t.dtype == DTYPES[dt][0]
        # bc from the host's float64 pow vs jnp's float32 pow: 1 ulp in fp32
        tol = 2.0 ** -22 if dt == "f32" else 2.0 ** -8
        np.testing.assert_allclose(_f32(t), _f32(w), rtol=tol,
                                   atol=tol * float(np.abs(_f32(w)).max()))


def _r_adamw_update(g, m, v, p, count):
    from repro.train import optim as r_optim
    state = r_optim.AdamWState({"w": m}, {"w": v}, count)
    new_p, new_s = r_optim.adamw_update({"w": g}, state, {"w": p})
    return new_p["w"], new_s


def test_adamw_inplace_writes_over_its_operands():
    n = 1001
    g, m, v, p = (torch.from_numpy(_rand((n,), i)) for i in range(4))
    v = v.abs()
    bc = torch.tensor([0.1, 0.05])
    want = adamw.adamw_ref(g, m, v, p, bc, lr=1e-3, b1=0.9, b2=0.95,
                           eps=1e-8, weight_decay=0.1)
    out = adamw.fused_adamw(g, m, v, p, bc, lr=1e-3, inplace=True)
    assert out[0] is p and out[1] is m and out[2] is v
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"\(2,\) float32"):
        adamw.fused_adamw(g, m, v, p, bc.double())
    with pytest.raises(ValueError, match="shapes differ"):
        adamw.fused_adamw(g[:5], m, v, p, bc)


# --------------------------------------------------------------------------
# routed ops: values, gradients (backward recomputes the plain math)
# --------------------------------------------------------------------------

def _grad_close(t, j, dtype: str, atol: float = 1e-6) -> None:
    a, b = _f32(t), _f32(j)
    if dtype == "f32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
    else:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2.0 ** -7 * float(np.abs(b).max()))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_grads_match_jax_vjp(dtype):
    x_t, x_j = _pair(_rand((3, 5, 24), 10), dtype)
    s_np = np.random.default_rng(11).uniform(0.5, 1.5, 24).astype(np.float32)
    gy_t, gy_j = _pair(_rand((3, 5, 24), 12), dtype)
    jdt = DTYPES[dtype][1]
    _, vjp = jax.vjp(lambda a, s: r_ops._rms_ref(a, s, 1e-5, jdt),
                     x_j.reshape(-1, 24), jnp.asarray(s_np))
    gx_j, gs_j = vjp(gy_j.reshape(-1, 24))
    xl = x_t.clone().requires_grad_()
    sl = torch.from_numpy(s_np).requires_grad_()
    y = ops.rmsnorm(xl, sl)
    assert y.shape == x_t.shape and y.dtype == x_t.dtype
    gx, gs = torch.autograd.grad(y, (xl, sl), gy_t)
    _grad_close(gx.reshape(-1, 24), gx_j, dtype)
    _grad_close(gs, gs_j, "f32" if dtype == "f32" else dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_residual_grads_match_jax_vjp(dtype):
    shape = (9, 40)
    x_t, x_j = _pair(_rand(shape, 13), dtype)
    h_t, h_j = _pair(_rand(shape, 14), dtype)
    gr_t, gr_j = _pair(_rand(shape, 15), dtype)
    gy_t, gy_j = _pair(_rand(shape, 16), dtype)
    s = np.full(40, 0.7, np.float32)
    jdt = DTYPES[dtype][1]

    def ref(a, b, sc):
        r = a + b
        return r, r_ops._rms_ref(r, sc, 1e-5, jdt)

    _, vjp = jax.vjp(ref, x_j, h_j, jnp.asarray(s))
    want = vjp((gr_j, gy_j))
    leaves = [x_t.clone().requires_grad_(), h_t.clone().requires_grad_(),
              torch.from_numpy(s).requires_grad_()]
    r, y = ops.rmsnorm_residual(*leaves)
    got = torch.autograd.grad((r, y), leaves, (gr_t, gy_t))
    for a, b in zip(got, want):
        _grad_close(a, b, dtype)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu_grads_match_jax_vjp(dtype, act):
    shape = (2, 7, 33)
    g_t, g_j = _pair(_rand(shape, 17, 2.0), dtype)
    u_t, u_j = _pair(_rand(shape, 18), dtype)
    gy_t, gy_j = _pair(_rand(shape, 19), dtype)
    jdt = DTYPES[dtype][1]

    def ref(a, b):
        af = a.astype(jnp.float32)
        h = jax.nn.silu(af) if act == "silu" else jax.nn.gelu(af)
        return (h * b.astype(jnp.float32)).astype(jdt)

    _, vjp = jax.vjp(ref, g_j, u_j)
    want = vjp(gy_j)
    leaves = [g_t.clone().requires_grad_(), u_t.clone().requires_grad_()]
    got = torch.autograd.grad(ops.swiglu(*leaves, act=act), leaves, gy_t)
    for a, b in zip(got, want):
        floor = 1e-5 * float(np.abs(_f32(b)).max()) if act == "gelu" else 0
        _grad_close(a, b, dtype, atol=max(floor, 1e-6))


def test_embed_onehot_grad_matches_scatter():
    rng = np.random.default_rng(20)
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 50, (3, 7)))
    gy = torch.from_numpy(rng.standard_normal((3, 7, 8)).astype(np.float32))
    t1 = table.clone().requires_grad_()
    y1 = ops.embed_with_onehot_grad(t1, tokens, torch.bfloat16)
    t2 = table.clone().requires_grad_()
    y2 = t2.to(torch.bfloat16)[tokens]
    assert torch.equal(y1, y2)
    (g1,) = torch.autograd.grad(y1, t1, gy.bfloat16())
    (g2,) = torch.autograd.grad(y2, t2, gy.bfloat16())
    # the scatter accumulates repeated tokens in bf16, the matmul in fp32
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=0,
                               atol=2.0 ** -7 * float(g1.abs().max()))
    # the reference's custom VJP on the same inputs
    f = r_ops.embed_with_onehot_grad
    _, vjp = jax.vjp(lambda t: f(t, jnp.asarray(tokens.numpy()),
                                 jnp.bfloat16), jnp.asarray(table.numpy()))
    (gj,) = vjp(jnp.asarray(gy.numpy(), jnp.bfloat16))
    np.testing.assert_allclose(g1.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# eligibility, routing and the fake implementations
# --------------------------------------------------------------------------

_ELIGIBILITY_CASES = [
    ((4, 64), "float32", (64,)), ((2, 3, 64), "bfloat16", (64,)),
    ((64,), "float32", (64,)), ((4, 0), "float32", (0,)),
    ((4, 16_384), "bfloat16", (16_384,)), ((4, 16_385), "float32", (16_385,)),
    ((4, 64), "float16", (64,)), ((4, 64), "float32", (32,)),
    ((4, 32_768), "float32", (32_768,)), ((4, 32_769), "float32", (32_769,)),
]


@pytest.mark.parametrize("shape,dtype,sshape", _ELIGIBILITY_CASES)
def test_eligibility_verdicts_match_reference(shape, dtype, sshape):
    t = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    s = torch.empty(sshape, device="meta")
    j = jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))
    js = jax.ShapeDtypeStruct(sshape, jnp.float32)
    assert ops.norm_eligible(t, s) == r_ops.norm_eligible(j, js)
    assert ops.swiglu_eligible(t, t) == r_ops.swiglu_eligible(j, j)
    assert ops.adamw_eligible(t, t, t, t) == r_ops.adamw_eligible(j, j, j, j)
    other = torch.empty((3,), device="meta")
    assert ops.swiglu_eligible(t, other) == r_ops.swiglu_eligible(
        j, jax.ShapeDtypeStruct((3,), jnp.float32))


@pytest.mark.parametrize("tokens,vocab", [((4, 32), 512), ((2, 2048), 151_552),
                                          ((0,), 10), ((256, 256), 1024),
                                          ((256, 257), 1024)])
def test_embed_eligibility_matches_reference(tokens, vocab):
    t = torch.empty(tokens, dtype=torch.int32, device="meta")
    j = jax.ShapeDtypeStruct(tokens, jnp.int32)
    assert ops.embed_grad_eligible(t, vocab) == \
        r_ops.embed_grad_eligible(j, vocab)
    assert (ops.NORM_D_MAX, ops.SWIGLU_D_MAX, ops.ONEHOT_BYTES_MAX) == \
        (r_ops.NORM_D_MAX, r_ops.SWIGLU_D_MAX, r_ops.ONEHOT_BYTES_MAX)


def test_fusion_enabled_and_use_predicates():
    from repro_torch.configs.base import RunConfig
    x, s = torch.zeros(4, 8), torch.ones(8)
    assert not ops.fusion_enabled(None)
    assert not ops.fusion_enabled(RunConfig(fusion="off"))
    assert ops.fusion_enabled(RunConfig(fusion="static"))
    run = RunConfig(fusion="static")
    assert ops.use_norm(run, x, s) and not ops.use_norm(None, x, s)
    assert not ops.use_norm(run, x.double(), s)
    assert ops.use_swiglu(run, x, x) and not ops.use_swiglu(run, x, x[:2])
    assert ops.use_adamw(run, x, x, x, x)
    assert ops.use_embed(run, torch.zeros(512, 8),
                         torch.zeros(4, 32, dtype=torch.int32), torch.float32)


def test_fakes_on_meta_give_shapes_and_allocate_nothing():
    x = torch.empty(3, 5, 64, dtype=torch.bfloat16, device="meta")
    s = torch.empty(64, device="meta")
    y = ops.rmsnorm(x, s)
    assert y.device.type == "meta" and y.shape == x.shape \
        and y.dtype == torch.bfloat16
    assert ops.rmsnorm(x, s, out_dtype=torch.float32).dtype == torch.float32
    r, y = ops.rmsnorm_residual(x, x, s)
    assert r.shape == y.shape == x.shape and r.device.type == "meta"
    g = ops.swiglu(x, x, act="gelu")
    assert g.shape == x.shape and g.device.type == "meta"
    p = torch.empty(7, 3, dtype=torch.bfloat16, device="meta")
    q = torch.empty(5, device="meta")
    bc = torch.empty(2, device="meta")
    outs = ops.adamw_group([p.float(), q], [p, q], [p, q], [p, q], bc,
                           lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                           weight_decay=0.1)
    assert [[o.shape for o in out] for out in outs] == \
        [[p.shape, q.shape]] * 3
    assert all(o.device.type == "meta" and o is not p
               for out in outs for o in out)
    same = ops.adamw_group([p.float()], [p], [p], [p], bc, lr=1e-3, b1=0.9,
                           b2=0.95, eps=1e-8, weight_decay=0.1, inplace=True)
    assert same[0][0] is p


def test_wrappers_take_plain_path_on_cpu_without_counting():
    kernels.reset_launch_counts()
    x = torch.from_numpy(_rand((5, 9), 21))
    norm.fused_rmsnorm(x, torch.ones(9))
    norm.fused_rmsnorm_residual(x, x, torch.ones(9))
    swiglu.fused_swiglu(x, x)
    adamw.fused_adamw(x, x, x.abs(), x, torch.tensor([0.1, 0.05]))
    norm.fused_layernorm(x, torch.ones(9), torch.zeros(9))
    counts = kernels.launch_counts()
    assert set(counts) == {"triad", "fma_chain", "ert_gemm", "fused_rmsnorm",
                           "fused_rmsnorm_residual", "fused_layernorm",
                           "fused_swiglu", "fused_adamw", "flash_attention",
                           "flash_attention_bwd", "ssd_scan"}
    assert all(c == 0 for c in counts.values())


def test_wrappers_refuse_meta_tensors():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        norm.fused_rmsnorm(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        swiglu.fused_swiglu(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        adamw.fused_adamw(x, x, x, x, torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="differs"):
        norm.fused_rmsnorm_residual(torch.zeros(4, 8),
                                    torch.zeros(4, 8).double(),
                                    torch.ones(8))
    with pytest.raises(ValueError, match="2D"):
        norm.fused_rmsnorm(torch.zeros(8), torch.ones(8))


def test_the_library_interface_is_declared():
    sig = build._SIGNATURES["fused"]
    assert set(sig) == {"fused_rmsnorm", "fused_layernorm", "fused_swiglu",
                        "fused_adamw_multi", "fused_error_string"}
    assert build.library_path("fused").name.startswith("libfused_")
    src = (build.CSRC / "fused.cu").read_text()
    for name in ("fused_rmsnorm", "fused_layernorm", "fused_swiglu",
                 "fused_adamw_multi", "fused_error_string"):
        assert f" {name}(" in src
    for ref in ("norm.py::fused_rmsnorm", "norm.py::fused_rmsnorm_residual",
                "norm.py::fused_layernorm", "swiglu.py::fused_swiglu",
                "adamw.py::fused_adamw"):
        assert ref in src
    from repro_torch.kernels import config as kc
    assert {"fused_norm", "fused_swiglu", "fused_adamw"} <= set(kc.DEFAULTS)


# --------------------------------------------------------------------------
# roofline models and the op walk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,itemsize", [(4096, 4096, 2), (7, 100, 4)])
def test_hbm_bytes_match_reference(rows, d, itemsize):
    for res in (False, True):
        assert norm.hbm_bytes(rows, d, itemsize, residual=res) == \
            r_norm.hbm_bytes(rows, d, itemsize, residual=res)
    assert swiglu.hbm_bytes(rows, d, itemsize) == \
        r_swiglu.hbm_bytes(rows, d, itemsize)
    n = rows * d
    assert adamw.hbm_bytes(n, itemsize) == r_adamw.hbm_bytes(n, itemsize) + 8


def test_op_walk_counts_each_fused_op_as_one_custom_kernel():
    x = torch.empty(4096, 4096, dtype=torch.bfloat16)
    s = torch.empty(4096)
    gu = torch.empty(4096, 13_696, dtype=torch.bfloat16)

    def fn(x, s, gu):
        y = ops.rmsnorm(x, s)
        r, y2 = ops.rmsnorm_residual(x, y, s)
        return ops.swiglu(gu, gu)

    a = analyze_fn(fn, (x, s, gu))
    recs = {k.opcode: k for k in a.kernels}
    assert set(recs) == {"rmsnorm", "rmsnorm_residual", "swiglu"}
    assert all(k.category == "custom" and not k.is_zero_ai
               for k in a.kernels)
    assert recs["rmsnorm"].hbm_bytes == norm.hbm_bytes(4096, 4096, 2)
    assert recs["rmsnorm_residual"].hbm_bytes == \
        norm.hbm_bytes(4096, 4096, 2, residual=True)
    assert recs["swiglu"].hbm_bytes == swiglu.hbm_bytes(4096, 13_696, 2)
    assert recs["rmsnorm"].flops == norm.flops(4096, 4096)
    assert recs["swiglu"].flops_by_class == {"bf16": 3 * 4096 * 13_696}

    n = 4096 * 151_552
    p = torch.empty(4096, 151_552)

    def opt(p):
        ops.adamw_group([p], [p], [p], [p], torch.empty(2), lr=1e-3, b1=0.9,
                        b2=0.95, eps=1e-8, weight_decay=0.1, inplace=True)

    (rec,) = analyze_fn(opt, (p,)).kernels
    assert rec.opcode == "adamw_multi_" and rec.category == "custom"
    assert rec.hbm_bytes == adamw.hbm_bytes(n) and rec.flops == 16 * n


@pytest.fixture(scope="module")
def census():
    out = {}
    for fusion in ("off", "static"):
        res = Session(device="cpu").profile("glm4-9b", seq=32, batch=4,
                                            amp="O1", fusion=fusion)
        out[fusion] = res.analyses
    return out


@pytest.mark.parametrize("fusion", ["off", "static"])
def test_phase_matmul_flops_on_smoke(census, fusion):
    got = tuple(sum(k.total_flops for k in census[fusion][ph].kernels
                    if k.category == "matmul") for ph in ("fwd", "bwd", "opt"))
    assert got == SMOKE[fusion]


def test_static_has_fewer_zero_ai_launches(census):
    """fwd and opt drop (the norms' casts and the optimizer's chain and
    copies become one kernel each); the whole step drops.  The bwd phase
    rises a little: the fused ops' backward recomputes the plain math in
    fp32, which casts its bf16 inputs and gradients (the unfused SwiGLU
    runs in bf16 with no casts)."""
    z = {f: {ph: a.zero_ai_census()["zero-AI"][0] for ph, a in an.items()}
         for f, an in census.items()}
    assert z["static"]["fwd"] < z["off"]["fwd"]
    assert z["static"]["opt"] < z["off"]["opt"]
    assert sum(z["static"].values()) < sum(z["off"].values())
    customs = {k.opcode for k in census["static"]["fwd"].kernels
               if k.category == "custom"}
    assert customs == {"rmsnorm", "rmsnorm_residual", "swiglu"}
    assert {k.opcode for k in census["static"]["opt"].kernels
            if k.category == "custom"} == {"adamw_multi_"}
    assert not any(k.category == "custom"
                   for a in census["off"].values() for k in a.kernels)


def test_full_width_static_bwd_keeps_the_scatter():
    """glm4-9b at full width, 4 layers, seq 2048, batch 2: the one-hot
    would be 4096·151,552·4 B > 2^28, so the embedding backward keeps the
    scatter and bwd's matmul FLOPs are exactly 3× fwd's (on meta tensors:
    nothing is allocated)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import api as M
    from repro_torch.models.params import leaves
    from repro_torch.models.transformer import matmul_flops
    cfg4 = dataclasses.replace(get_config("glm4-9b"), n_layers=4)
    assert 2 * 2048 * cfg4.vocab_padded * 4 > ops.ONEHOT_BYTES_MAX
    res = Session(device="cpu").profile(
        "glm4-9b", smoke=False, n_layers=4, seq=2048, batch=2,
        fusion="static")
    mm = {ph: sum(k.total_flops for k in a.kernels if k.category == "matmul")
          for ph, a in res.analyses.items()}
    assert mm == {"fwd": matmul_flops(cfg4, 2, 2048),
                  "bwd": 3 * matmul_flops(cfg4, 2, 2048), "opt": 0}
    # the 12 leaves in one multi-tensor call (one launch: one dtype group),
    # whose record carries the sums of the 12 one-leaf records it replaces
    adam = [k for k in res.analyses["opt"].kernels
            if k.opcode == "adamw_multi_"]
    numels = [int(np.prod(spec.shape))
              for _, spec in leaves(M.build(cfg4).spec)]
    assert len(numels) == 12 and sum(k.exec_count for k in adam) == 1
    assert adam[0].hbm_bytes == sum(adamw.hbm_bytes(n) for n in numels)
    assert adam[0].flops == sum(adamw.flops(n) for n in numels)
