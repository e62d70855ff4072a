"""The port's SSD scan against the reference's, on the CPU.

On CPU tensors the kernel's wrappers run their plain versions
(``ssd_ref`` on the kernel layout, ``ssd_chunked`` on the model layout);
the CUDA kernel itself is held against them on the card by
``chip_smoke.py``.  Inputs are drawn with numpy, as the reference's own
tests draw them (x and B/C at scale 0.5, a = -0.1·|N(0, 1)|), and handed
to both packages.  Tolerances:

* fp32: 1e-5 · max|ref| — the same fp32 math, summed in another order;
* bf16 (the ``xla`` route under O1): 2^-6 · max|ref| — the products run
  in bf16 in both, but XLA on the CPU keeps some fused intermediates in
  fp32 where eager PyTorch rounds each op (M = scores · decay, then
  C · state times exp(cum)), so outputs land a few bf16 spacings apart
  (up to 1.5 · 2^-8 · max|ref| measured);
* gradients (fp32): 1e-5 · max|ref| of each gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import kernel as r_kernel
from repro.kernels.ssd_scan.ref import ssd_ref as r_ssd_ref
from repro.models.ssm import ssd_chunked as r_ssd_chunked
from repro_torch import kernels
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.ssd_scan import kernel as p_kernel
from repro_torch.kernels.ssd_scan import ops as p_ops
from repro_torch.kernels.ssd_scan.ref import kernel_tolerance, ssd_ref
from repro_torch.models.ssm import ssd_chunked

# (B, H, S, P, N, chunk): the reference's tests/test_kernels.py shapes
SHAPES = [(2, 3, 256, 16, 8, 64), (1, 2, 128, 32, 16, 32),
          (2, 1, 64, 8, 8, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _inputs(seed: int, b, h, s, p, n, layout: str = "model"):
    """x, a, B, C as float32 numpy arrays; x (B, S, H, P) and a (B, S, H)
    in the model layout, (B, H, S, P) and (B, H, S) in the kernel's."""
    rng = np.random.default_rng(seed)
    x_shape, a_shape = (((b, s, h, p), (b, s, h)) if layout == "model"
                        else ((b, h, s, p), (b, h, s)))
    x = (rng.standard_normal(x_shape) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal(a_shape)) * 0.1).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    return x, a, bm, cm


def _pair(arrs, dtype: str):
    """The four operands for both packages; a (the log-decay) stays fp32,
    as the model passes it."""
    jd, td = DTYPES[dtype]
    x, a, bm, cm = arrs
    ref = (jnp.asarray(x, jd), jnp.asarray(a), jnp.asarray(bm, jd),
           jnp.asarray(cm, jd))
    port = (torch.from_numpy(x).to(td), torch.from_numpy(a),
            torch.from_numpy(bm).to(td), torch.from_numpy(cm).to(td))
    return ref, port


def _assert_close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert str(got.dtype).removeprefix("torch.") == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=REL[dtype] * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", SHAPES)
def test_ssd_chunked_matches_reference(dims, dtype):
    b, h, s, p, n, q = dims
    ref, port = _pair(_inputs(0, b, h, s, p, n), dtype)
    r_y, _ = jax.jit(lambda *t: r_ssd_chunked(*t, q))(*ref)
    _assert_close(ssd_chunked(*port, q), r_y, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", SHAPES)
def test_ssd_ref_and_wrapper_match_reference_on_kernel_layout(dims, dtype):
    b, h, s, p, n, q = dims
    ref, port = _pair(_inputs(1, b, h, s, p, n, layout="kernel"), dtype)
    want = r_ssd_ref(*ref, chunk=q)
    _assert_close(ssd_ref(*port, chunk=q), want, dtype)
    _assert_close(p_kernel.ssd_scan(*port, chunk=q), want, dtype)
    cfg = kc.default_config("ssd_scan").replace(chunk=q)
    _assert_close(p_kernel.ssd_scan(*port, config=cfg), want, dtype)


def test_model_layout_op_matches_reference_model_math():
    b, s, h, p, n, q = 1, 64, 2, 8, 4, 32
    ref, port = _pair(_inputs(2, b, h, s, p, n), "float32")
    want, _ = r_ssd_chunked(*ref, q)
    _assert_close(p_ops.ssd_scan_model_layout(*port, q), want, "float32")
    # chunk=None is the config default (128), clamped to S
    want_default, _ = r_ssd_chunked(*ref, min(128, s))
    _assert_close(p_ops.ssd_scan_model_layout(*port), want_default,
                  "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_invariance(dtype):
    """The output does not depend on the chunk size (the math property
    the reference's tests/test_models.py checks)."""
    b, s, h, p, n = 2, 128, 3, 8, 4
    x, a, bm, cm = _inputs(3, b, h, s, p, n)
    _, port = _pair((x * 0.6, a, bm * 0.6, cm * 0.6), dtype)
    y32 = ssd_chunked(*port, 32)
    y128 = ssd_chunked(*port, 128)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6 * y128.abs().max()
    assert float((y32.float() - y128.float()).abs().max()) < tol


@pytest.mark.parametrize("q", [16, 32])
def test_gradients_of_the_op_match_reference_vjp(q):
    b, s, h, p, n = 2, 64, 3, 8, 4
    x, a, bm, cm = _inputs(4 + q, b, h, s, p, n)
    g = np.random.default_rng(q).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *t: r_ssd_chunked(*t, q)[0],
                     *(jnp.asarray(t) for t in (x, a, bm, cm)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, a, bm, cm)]
    got = torch.autograd.grad(p_ops.ssd_scan_model_layout(*leaves, q),
                              leaves, torch.from_numpy(g))
    for gp, gr in zip(got, want):
        gr = np.asarray(gr)
        np.testing.assert_allclose(gp.numpy(), gr, rtol=0,
                                   atol=1e-5 * float(np.abs(gr).max()))


@pytest.mark.parametrize("dims", [(2, 64, 2048, 64, 128, 256),
                                  (2, 64, 2048, 64, 128, 128),
                                  (2, 3, 256, 16, 8, 64)])
def test_roofline_model_matches_reference(dims):
    for itemsize in (2, 4):
        assert (p_kernel.hbm_bytes(*dims[:5], itemsize)
                == r_kernel.hbm_bytes(*dims[:5], itemsize))
    assert p_kernel.flops(*dims) == r_kernel.flops(*dims)


@pytest.mark.parametrize("dims,want", [
    ((2, 64, 2048, 64, 128, 256), 11_996_364_800),
    ((2, 3, 256, 16, 8, 64), None), ((1, 2, 128, 32, 16, 32), None),
    ((2, 1, 64, 8, 8, 64), None)])
def test_needed_flops_count_only_the_work_the_scan_needs(dims, want):
    """Walk the chunks: C·Bᵀ once per (batch, chunk) over the causal pairs;
    per head the decay product and M·x over them, C·stateᵀ after a first
    chunk and the state update before the last."""
    b, h, s, p, n, q = dims
    nc = s // q
    pairs = int(np.tril(np.ones((q, q))).sum())
    count = 0
    for c in range(nc):
        count += b * pairs * 2 * n
        count += b * h * pairs * (1 + 2 * p)
        count += b * h * 2 * q * p * n * ((c > 0) + (c < nc - 1))
    assert p_kernel.needed_flops(*dims) == count
    assert p_kernel.needed_flops(*dims) < p_kernel.flops(*dims)
    if want is not None:
        assert count == want


@pytest.mark.parametrize("dims,want_flops,want_bytes", [
    ((2, 2048, 64, 64, 128, 256), 34_359_738_368, 139_460_608),
    ((1, 64, 2, 8, 4, 32), None, None)])
def test_op_walk_counts_one_custom_record_with_the_mirrored_model(
        dims, want_flops, want_bytes):
    b, s, h, p, n, q = dims
    meta = dict(device="meta", dtype=torch.float32)
    args = (torch.empty((b, s, h, p), **meta), torch.empty((b, s, h), **meta),
            torch.empty((b, s, n), **meta), torch.empty((b, s, n), **meta))
    ana = analyze_fn(lambda *t: p_ops.ssd_scan_model_layout(*t, q), args)
    (rec,) = ana.kernels
    assert rec.opcode == "ssd_scan" and rec.category == "custom"
    assert rec.exec_count == 1
    assert rec.flops_by_class == {"f32": r_kernel.flops(b, h, s, p, n, q)}
    assert rec.hbm_bytes == rec.vmem_bytes == \
        r_kernel.hbm_bytes(b, h, s, p, n, 4)
    if want_flops is not None:
        assert (rec.flops, rec.hbm_bytes) == (want_flops, want_bytes)


def test_a_chunk_that_does_not_divide_s_raises():
    x, a, bm, cm = (torch.from_numpy(t) for t in
                    _inputs(5, 1, 2, 100, 8, 4, layout="kernel"))
    with pytest.raises(ValueError, match="S % chunk"):
        p_kernel.ssd_scan(x, a, bm, cm, chunk=32)
    xm, am = x.transpose(1, 2), a.transpose(1, 2)
    with pytest.raises(ValueError, match="S % chunk"):
        p_ops.ssd_scan_model_layout(xm, am, bm, cm, 32)
    with pytest.raises(ValueError, match="S % chunk"):
        p_kernel.ssd_scan_model(xm.contiguous(), am.contiguous(), bm, cm,
                                chunk=32)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    kernels.reset_launch_counts()
    x, a, bm, cm = (torch.from_numpy(t) for t in
                    _inputs(6, 1, 2, 64, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        p_kernel.ssd_scan_model(x, a, bm, cm, chunk=32)
    meta = [t.to("meta") for t in (x, a, bm, cm)]
    with pytest.raises(ValueError, match="CUDA"):
        p_kernel.ssd_scan_model(*meta, chunk=32)
    out = p_ops.ssd_scan_model_layout(*meta, 32)
    assert out.device.type == "meta" and out.shape == x.shape
    with pytest.raises(TypeError, match="dtype"):
        p_kernel.ssd_scan_model(x.to(torch.bfloat16), a, bm, cm, chunk=32)
    with pytest.raises(ValueError, match="chunks up to 256"):
        p_kernel.ssd_scan_model(
            torch.zeros(1, 512, 1, 8), torch.zeros(1, 512, 1),
            torch.zeros(1, 512, 4), torch.zeros(1, 512, 4), chunk=512)
    with pytest.raises(ValueError, match="shapes"):
        p_kernel.ssd_scan_model(x, a[:, :, :1], bm, cm, chunk=32)
    assert kernels.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("field", ["block_q", "block_p", "threads",
                                   "max_chunk", "max_state"])
def test_a_config_that_changes_a_compiled_field_raises(field):
    x, a, bm, cm = (torch.from_numpy(t) for t in
                    _inputs(7, 1, 2, 64, 8, 4, layout="kernel"))
    cfg = kc.default_config("ssd_scan")
    # the chunk is read at run time, so a config may change it
    p_kernel.ssd_scan(x, a, bm, cm, config=cfg.replace(chunk=32))
    with pytest.raises(ValueError, match=f"compiled for .*{field}"):
        p_kernel.ssd_scan(x, a, bm, cm,
                          config=cfg.replace(**{field: cfg.get(field) * 2}))


def test_the_library_interface_is_declared():
    sig = build._SIGNATURES["ssd"]
    assert set(sig) == {"ssd_scan_fwd", "ssd_tile", "ssd_error_string"}
    assert build.library_path("ssd").name.startswith("libssd_")
    src = (build.CSRC / "ssd.cu").read_text()
    for name in sig:
        assert f" {name}(" in src
    assert "ssd_scan/kernel.py::ssd_scan" in src
    cfg = kc.default_config("ssd_scan")
    assert {k: cfg.get(k) for k in ("block_q", "block_p", "threads",
                                    "max_chunk", "max_state")} == {
        "block_q": 64, "block_p": 64, "threads": 256, "max_chunk": 256,
        "max_state": 128}
    for const in ("kBQ = 64", "kBP = 64", "kOutWarps = 8", "kQMax = 256",
                  "kNMax = 128"):
        assert const in src
    # the three launches (C·Bᵀ and the increments, the pass over the
    # chunks, the outputs), and the tensor cores at fp32 accuracy (3xTF32)
    assert "ssd_pass_kernel<<<" in src
    for kernel in ("ssd_chunk_kernel", "ssd_out_kernel"):
        assert f"{kernel}<true>" in src and f"{kernel}<false>" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src
    # the scratch the wrapper allocates: ssd_scan_fwd's three extra pointers
    assert len(sig["ssd_scan_fwd"]) == 16


# --------------------------------------------------------------------------
# the per-chunk tolerance rule (what chip_smoke.py holds the kernel to)
# --------------------------------------------------------------------------

def _sequential(x, a, bm, cm, chunk, *, drop_row_into_last=None):
    """The kernel's arithmetic on the kernel layout, on the host: per
    (b, h) the chunks in order with an fp32 (P, N) state, the reference
    Pallas kernel's per-chunk form — the same function as ``ssd_ref``,
    summed in another order.  ``drop_row_into_last`` leaves that row of
    the second-to-last chunk out of the state carried into the last chunk
    (a kernel that loses a key row of its state update)."""
    b, h, s, p = x.shape
    n = bm.shape[-1]
    nc = s // chunk
    y = torch.empty_like(x)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    iq = torch.arange(chunk)
    mask = iq[:, None] >= iq[None, :]
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, ac = x[:, :, sl].double(), a[:, :, sl].double()
        bc, cc = bm[:, sl].double(), cm[:, sl].double()
        cum = ac.cumsum(-1)                               # (b, h, Q)
        total = cum[..., -1:]
        seg = cum[..., :, None] - cum[..., None, :]
        decay = torch.where(mask, seg, float("-inf")).exp()
        m = (cc @ bc.transpose(1, 2))[:, None] * decay
        y[:, :, sl] = (m @ xc + cum.exp()[..., None]
                       * (cc[:, None] @ state.transpose(2, 3))).float()
        w = (total - cum).exp()
        if c == nc - 2 and drop_row_into_last is not None:
            w = w.clone()
            w[..., drop_row_into_last] = 0.0
        state = total.exp()[..., None] * state + xc.transpose(2, 3) @ (
            bc[:, None] * w[..., None])
    return y


@pytest.fixture(scope="module")
def _late_chunk_case():
    """Kernel-layout inputs whose first chunk's outputs are 1000 times
    those of the last chunk, and the plain version's output on them."""
    b, h, s, p, n, q = 1, 2, 256, 16, 16, 64
    x, a, bm, cm = (torch.from_numpy(t) for t in
                    _inputs(7, b, h, s, p, n, layout="kernel"))
    x[:, :, :q] *= 1000.0
    return x, a, bm, cm, q, ssd_ref(x, a, bm, cm, chunk=q)


def test_kernel_tolerance_passes_the_sequential_order(_late_chunk_case):
    x, a, bm, cm, q, want = _late_chunk_case
    err = (_sequential(x, a, bm, cm, q) - want).abs()
    assert (err / kernel_tolerance(want, q)).max().item() <= 0.1


def test_kernel_tolerance_flags_a_wrong_state_into_the_last_chunk(
        _late_chunk_case):
    """Losing the first key row of the second-to-last chunk from the state
    carried into the last chunk (its weight exp(total - cum_0) is the
    chunk's smallest) stays under one bound for the whole output (1e-4 of
    its max, which the first chunk sets) but breaks the last chunk's own
    bound."""
    x, a, bm, cm, q, want = _late_chunk_case
    got = _sequential(x, a, bm, cm, q, drop_row_into_last=0)
    err = (got - want).abs()
    assert err.max().item() <= 1e-4 * want.abs().max().item()
    ratio = err / kernel_tolerance(want, q)
    assert ratio[:, :, -q:].max().item() > 1.0
    assert ratio[:, :, :-q].max().item() <= 0.1


def test_kernel_tolerance_is_per_block():
    want = torch.zeros(1, 2, 4, 3)
    want[0, 0, :2] = 5.0
    want[0, 1, 2:] = -2.0
    tol = kernel_tolerance(want, 2)
    assert tol.shape == (1, 2, 4, 1)
    tiny = torch.finfo(torch.float32).tiny
    assert torch.allclose(tol[0, :, :, 0], torch.tensor(
        [[5e-4, 5e-4, tiny, tiny], [tiny, tiny, 2e-4, 2e-4]]))
