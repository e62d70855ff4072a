"""The port's flash attention against the reference's, on the CPU.

On CPU tensors the kernel's wrappers run their plain versions
(``attention_ref`` on the (BH, S, hd) layout, ``_ref_gqa`` on the model
layout); the CUDA kernel itself is held against them on the card by
``chip_smoke.py``.  Inputs are drawn with numpy and handed to both
packages (bf16 through fp32, which is exact).  Tolerances:

* fp32: atol 1e-5 — the same fp32 math, summed in another order;
* bf16: 1 bf16 spacing at max|ref| (2^-8 · max|ref|) — both compute in
  fp32 and round once at the end, so only an fp32 difference in the last
  bits can move the rounding;
* gradients (fp32): atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as r_kernel
from repro.kernels.flash_attention import ops as r_ops
from repro.kernels.flash_attention.ref import attention_ref as r_attention_ref
from repro.kernels.fused import ops as r_fops
from repro_torch import kernels
from repro_torch.kernels import config as kc
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.kernels.flash_attention import kernel as p_kernel
from repro_torch.kernels.flash_attention import ops as p_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     kernel_tolerance)
from repro_torch.kernels.fused import ops as p_fops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype: str):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _assert_close(p: torch.Tensor, r, dtype: str) -> None:
    want = np.asarray(jnp.asarray(r, jnp.float32))
    got = p.float().numpy()
    assert str(p.dtype).removeprefix("torch.") == dtype
    atol = 1e-5 if dtype == "float32" else \
        2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
def test_gqa_plain_version_matches_reference(G, dtype, causal):
    rng = np.random.default_rng(G)
    B, S, K, hd = 2, 24, 2, 16
    rq, pq = _pair(rng, (B, S, K, G, hd), dtype)
    rk, pk = _pair(rng, (B, S, K, hd), dtype)
    rv, pv = _pair(rng, (B, S, K, hd), dtype)
    _assert_close(p_ops.flash_attention_gqa(pq, pk, pv, causal=causal),
                  r_ops._ref_gqa(rq, rk, rv, causal), dtype)
    _assert_close(p_ops._ref_gqa(pq, pk, pv, causal),
                  r_ops._ref_gqa(rq, rk, rv, causal), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
def test_bh_layout_matches_reference_attention_ref(G, dtype, causal):
    """The (BH, S, hd) entry point; Sq != Sk as the reference allows."""
    rng = np.random.default_rng(10 + G)
    rq, pq = _pair(rng, (2 * G, 20, 8), dtype)
    rk, pk = _pair(rng, (2 * G, 28, 8), dtype)
    rv, pv = _pair(rng, (2 * G, 28, 8), dtype)
    want = r_attention_ref(rq, rk, rv, causal=causal)
    _assert_close(p_kernel.flash_attention(pq, pk, pv, causal=causal), want,
                  dtype)
    _assert_close(attention_ref(pq, pk, pv, causal=causal), want, dtype)


@pytest.mark.parametrize("G", [1, 4])
def test_gradient_matches_reference_vjp(G):
    rng = np.random.default_rng(20 + G)
    B, S, K, hd = 2, 16, 2, 8
    q = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    g = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: r_ops._ref_gqa(a, b, c, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = p_ops.flash_attention_gqa(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("sq", [1, 15, 16, 17, 32, 48, 100, 512, 1024, 2048])
@pytest.mark.parametrize("flags", [
    dict(causal=True, has_memory=False, has_cache=False, softmax_f32=True),
    dict(causal=False, has_memory=False, has_cache=False, softmax_f32=True),
    dict(causal=True, has_memory=True, has_cache=False, softmax_f32=True),
    dict(causal=True, has_memory=False, has_cache=True, softmax_f32=True),
    dict(causal=True, has_memory=False, has_cache=False, softmax_f32=False),
])
def test_flash_from_chunked_eligibility_matches_reference(sq, flags):
    for sk in (sq, 2 * sq):
        assert (p_fops.flash_from_chunked_eligible(sq, sk, **flags)
                == r_fops.flash_from_chunked_eligible(sq, sk, **flags))
    assert p_fops.FLASH_MIN_BLOCK == r_fops.FLASH_MIN_BLOCK
    assert (p_kernel.DEFAULT_BLOCK_Q, p_kernel.DEFAULT_BLOCK_K,
            p_kernel.NEG_INF) == (r_kernel.DEFAULT_BLOCK_Q,
                                  r_kernel.DEFAULT_BLOCK_K, r_kernel.NEG_INF)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(64, 2048, 2048, 128), (3, 17, 40, 8),
                                   (1, 1, 1, 256)])
def test_roofline_model_matches_reference(shape, causal):
    for itemsize in (2, 4):
        assert (p_kernel.hbm_bytes(*shape, itemsize)
                == r_kernel.hbm_bytes(*shape, itemsize))
    assert (p_kernel.flops(*shape, causal=causal)
            == r_kernel.flops(*shape, causal=causal))


def _meta_gqa(B, S, K, G, hd, dtype=torch.bfloat16):
    q = torch.empty((B, S, K, G, hd), dtype=dtype, device="meta")
    k = torch.empty((B, S, K, hd), dtype=dtype, device="meta")
    return q, k, torch.empty_like(k)


def test_op_walk_counts_one_custom_record_with_the_mirrored_model():
    B, S, K, G, hd = 2, 2048, 2, 16, 128
    ana = analyze_fn(lambda q, k, v: p_ops.flash_attention_gqa(q, k, v),
                     _meta_gqa(B, S, K, G, hd))
    (rec,) = ana.kernels
    assert rec.opcode == "flash_attention" and rec.category == "custom"
    assert rec.exec_count == 1
    assert rec.flops_by_class == {"bf16": r_kernel.flops(64, S, S, hd)}
    assert rec.flops == 68_719_476_736
    assert rec.hbm_bytes == rec.vmem_bytes == \
        r_kernel.hbm_bytes(64, S, S, hd, 2) == 134_217_728
    ana32 = analyze_fn(
        lambda q, k, v: p_ops.flash_attention_gqa(q, k, v, causal=False),
        _meta_gqa(1, 40, 1, 2, 8, torch.float32))
    (rec32,) = ana32.kernels
    assert rec32.flops_by_class == {"f32": r_kernel.flops(2, 40, 40, 8,
                                                          causal=False)}
    assert rec32.hbm_bytes == r_kernel.hbm_bytes(2, 40, 40, 8, 4)


def test_meta_tensors_launch_nothing():
    kernels.reset_launch_counts()
    q, k, v = _meta_gqa(1, 64, 2, 4, 16)
    out = p_ops.flash_attention_gqa(q, k, v)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == q.dtype
    with pytest.raises(ValueError, match="CUDA"):
        p_kernel.flash_attention_grouped(q, k, v)
    bh = torch.empty((8, 64, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        p_kernel.flash_attention(bh, bh, bh)
    assert kernels.launch_counts()["flash_attention"] == 0


def _gqa_zeros(hd, dtype=torch.bfloat16):
    return (torch.zeros(1, 4, 1, 2, hd, dtype=dtype),
            torch.zeros(1, 4, 1, hd, dtype=dtype),
            torch.zeros(1, 4, 1, hd, dtype=dtype))


@pytest.mark.parametrize("case, match", [
    ("shapes", "shapes"), ("dtypes", "dtypes"),
    ("hd_not_a_multiple_of_8", "multiple of 8"),
    ("hd_below_8", "multiple of 8"), ("hd_above_256", "up to 256"),
    ("heads_that_do_not_group", "do not group")])
def test_wrappers_refuse_what_the_kernel_does_not_take(case, match):
    """Each check the wrapper makes raises before anything is launched
    (the hd and head checks come before the one for CUDA tensors)."""
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        if case == "shapes":
            p_kernel.flash_attention_grouped(torch.zeros(1, 4, 1, 2, 8),
                                             torch.zeros(1, 4, 8),
                                             torch.zeros(1, 4, 8))
        elif case == "dtypes":
            p_kernel.flash_attention(torch.zeros(2, 4, 8),
                                     torch.zeros(2, 4, 8,
                                                 dtype=torch.bfloat16),
                                     torch.zeros(2, 4, 8))
        elif case == "heads_that_do_not_group":
            q, k, v = _gqa_zeros(8)
            p_kernel._launch(q, k, v, 1, 4, 4, 3, 2, 8, True)
        else:
            hd = {"hd_not_a_multiple_of_8": 12, "hd_below_8": 0,
                  "hd_above_256": 264}[case]
            p_kernel.flash_attention_grouped(*_gqa_zeros(hd))
    assert kernels.launch_counts()["flash_attention"] == 0


def _tiled(q, k, v, *, drop=None, stale_alpha_at=None, stale_v_from=None,
           block_k=64):
    """The kernel's arithmetic on (BH, S, hd) bf16 inputs, on the host:
    causal online softmax over key tiles in fp32, P rounded to bf16 for
    the PV product, l summed from the fp32 P, output rounded to bf16.
    The keywords break it the way a wrong kernel would: ``drop`` masks
    the key columns of a boolean (S,) mask, ``stale_alpha_at`` skips the
    rescale at one tile, ``stale_v_from`` reads the previous tile's V
    from that tile on (a double-buffer race)."""
    bh, s, hd = q.shape
    sc = (q.float() @ k.float().transpose(1, 2)) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    if drop is not None:
        mask &= ~drop
    sc = sc.masked_fill(~mask, float("-inf"))
    m = torch.full((bh, s, 1), float("-inf"))
    l, acc = torch.zeros(bh, s, 1), torch.zeros(bh, s, hd)
    for kt in range(0, s, block_k):
        st = sc[:, :, kt:kt + block_k]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new).nan_to_num(0.0)
        if kt // block_k == stale_alpha_at:
            alpha = torch.ones_like(alpha)
        p = torch.exp(st - m_new).nan_to_num(0.0)
        vt = v[:, kt:kt + block_k].float()
        if stale_v_from is not None and kt // block_k >= stale_v_from:
            vt = v[:, kt - block_k:kt].float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l).to(torch.bfloat16)


def _drop_key(s, j):
    d = torch.zeros(s, dtype=torch.bool)
    d[j] = True
    return d


def _drop_half_tile(s, kt, block_k):
    d = torch.zeros(s, dtype=torch.bool)
    d[kt * block_k + block_k // 2:(kt + 1) * block_k] = True
    return d


@pytest.fixture(scope="module")
def _bf16_late_tiles():
    """bf16 (BH, S, hd) inputs with S long enough that late query rows
    average hundreds of keys, and the plain version's output on them."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 768, 64), generator=g).to(torch.bfloat16)
               for _ in range(3))
    return q, k, v, attention_ref(q, k, v, causal=True)


#: the key tiles of the host model: the first kernel's 64 and the
#: compiled tile of the wgmma kernel (kernels/config.py)
BLOCK_KS = sorted({64, kc.DEFAULTS["flash_attention"].get("block_k")})


@pytest.mark.parametrize("block_k", BLOCK_KS)
def test_kernel_tolerance_passes_the_kernels_rounding(_bf16_late_tiles,
                                                      block_k):
    """The kernel's own roundings (P to bf16 for the tensor cores, the
    output once) stay within half the elementwise bound."""
    q, k, v, want = _bf16_late_tiles
    err = (_tiled(q, k, v, block_k=block_k).float() - want.float()).abs()
    assert (err / kernel_tolerance(want)).max().item() <= 0.5


@pytest.mark.parametrize("block_k", BLOCK_KS)
@pytest.mark.parametrize("fault", ["one_key", "half_tile", "stale_alpha",
                                   "stale_v"])
def test_kernel_tolerance_flags_a_wrong_late_tile(_bf16_late_tiles, fault,
                                                  block_k):
    """A kernel wrong only in a late key tile (the one that holds key
    600) fails the elementwise bound.  The one-key fault (one of 768 keys
    lost past row 600) passes a global 4 * 2^-8 * max|ref| bound, which
    the large outputs of the first rows set."""
    q, k, v, want = _bf16_late_tiles
    s, late = q.shape[1], 600 // block_k
    got = _tiled(q, k, v, block_k=block_k, **{
        "one_key": dict(drop=_drop_key(s, 600)),
        "half_tile": dict(drop=_drop_half_tile(s, late, block_k)),
        "stale_alpha": dict(stale_alpha_at=late),
        "stale_v": dict(stale_v_from=late)}[fault])
    err = (got.float() - want.float()).abs()
    assert (err > kernel_tolerance(want)).any()
    if fault == "one_key":
        assert err.max().item() <= 4 * 2.0 ** -8 * want.float().abs().max()


def test_kernel_tolerance_fp32_is_global():
    want = torch.tensor([[1.0, -4.0], [0.5, 0.25]])
    assert torch.equal(kernel_tolerance(want),
                       torch.full((2, 1), 4e-5))
