"""The flash-attention backward on the CPU: the backward kernel's
formulas in fp32 (``ops._ref_flash_bwd``, FA2 from the forward's saved
log-sum-exp) against autograd of the plain forward ``ops._ref_gqa``, the
op's lse and fake, the backward's routes, and the kernel wrapper's
refusals (it never falls back to a plain route)."""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.fused import ops as fops


def _inputs(b, sq, sk, kv, g, hd, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)
    return (r(b, sq, kv, g, hd), r(b, sk, kv, hd), r(b, sk, kv, hd),
            r(b, sq, kv, g, hd))


# (B, Sq, Sk, KV heads, G, hd): Sq = Sk, Sk > Sq (the top-left causal
# convention: query i sees keys j <= i), odd S
SHAPES = [(2, 16, 16, 2, 1, 8), (1, 24, 24, 2, 3, 16), (1, 12, 12, 1, 16, 8),
          (2, 9, 21, 1, 3, 8), (1, 17, 17, 2, 3, 24), (1, 13, 31, 2, 16, 8)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_equals_autograd_of_the_plain_forward(shape, causal):
    b, sq, sk, kv, g, hd = shape
    q, k, v, do = _inputs(b, sq, sk, kv, g, hd, seed=sum(shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops._ref_gqa(*leaves, causal), leaves, do)
    o, lse = ops._ref_gqa_lse(q, k, v, causal)
    got = ops._ref_flash_bwd(q, k, v, o, lse, do, causal)
    for name, a, w in zip("qkv", got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        tol = 1e-5 * max(1.0, w.abs().max().item())
        assert (a - w).abs().max().item() <= tol, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 3, 16])
def test_the_ops_gradient_on_the_cpu_is_the_plain_recompute(g, causal):
    """Bit for bit autograd of ``_ref_gqa``, and within fp32 rounding of
    the kernel's formulas."""
    q, k, v, do = _inputs(1, 19, 19, 2, g, 8, seed=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(
        ops.flash_attention_gqa(*leaves, causal=causal), leaves, do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops._ref_gqa(*plain, causal), plain, do)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    o, lse = ops._ref_gqa_lse(q, k, v, causal)
    for a, w in zip(got, ops._ref_flash_bwd(q, k, v, o, lse, do, causal)):
        assert (a - w).abs().max().item() <= 1e-5 * max(1.0, w.abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(16, 16), (9, 21), (15, 15)])
def test_the_ops_lse_is_the_logsumexp_of_the_scaled_masked_scores(sq, sk,
                                                                  causal):
    q, k, v, _ = _inputs(2, sq, sk, 2, 3, 16, seed=sq + sk)
    o, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal)
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * 16 ** -0.5
    if causal:
        s = s.masked_fill(torch.arange(sk)[None, :]
                          > torch.arange(sq)[:, None], float("-inf"))
    assert lse.shape == (2, 2, 3, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)
    assert torch.equal(o, ops._ref_gqa(q, k, v, causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_fake_gives_the_output_and_the_lse(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 40, 2, 3, 64, dtype=dtype)
        k = torch.empty(2, 56, 2, 64, dtype=dtype)
        o, lse = torch.ops.repro_torch.flash_attention(q, k, k, True)
    assert o.shape == q.shape and o.dtype == dtype
    assert lse.shape == (2, 2, 3, 40) and lse.dtype == torch.float32


def test_the_lse_carries_no_gradient_and_meta_runs_the_plain_recompute():
    q = torch.empty(1, 8, 2, 2, 16, device="meta", requires_grad=True)
    k = torch.empty(1, 8, 2, 16, device="meta", requires_grad=True)
    o, lse = torch.ops.repro_torch.flash_attention(q, k, k, True)
    assert o.requires_grad and not lse.requires_grad
    assert ops.bwd_route(q) == "recompute"
    gq, gk = torch.autograd.grad(o, (q, k), torch.empty_like(o))
    assert gq.shape == q.shape and gk.shape == k.shape


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "kernel"), (torch.float16, 128, "kernel"),
    (torch.bfloat16, 64, "kernel"), (torch.float16, 8, "kernel"),
    (torch.bfloat16, 72, "kernel"), (torch.bfloat16, 136, "plain"),
    (torch.bfloat16, 256, "plain"), (torch.bfloat16, 60, "plain"),
    (torch.float32, 128, "plain"), (torch.float32, 64, "plain"),
    (torch.float64, 64, "plain")])
def test_the_route_follows_dtype_and_head_dim(dtype, hd, route):
    assert fk.bwd_route(hd, dtype) == route
    # the op's backward: CPU tensors take the plain recompute whatever the
    # kernel route would be
    assert ops.bwd_route(torch.empty(1, 1, 1, 1, hd, dtype=dtype)) == \
        "recompute"


def _bwd_args(dtype=torch.bfloat16, hd=64, lse_dtype=torch.float32,
              device="cpu"):
    q, k, v, do = _inputs(1, 8, 8, 1, 2, hd, seed=1, dtype=dtype)
    lse = torch.zeros(1, 1, 2, 8, dtype=lse_dtype)
    return [t.to(device) for t in (q, k, v, q.clone(), lse, do)]


@pytest.mark.parametrize("case,match", [
    (dict(dtype=torch.float32), "bf16/fp16"),
    (dict(hd=136), "bf16/fp16"),
    (dict(hd=60), "bf16/fp16"),
    (dict(lse_dtype=torch.bfloat16), "lse must be"),
    (dict(), "CUDA"),
    (dict(device="meta"), "CUDA"),
])
def test_the_kernel_wrapper_refuses_what_it_does_not_take(case, match):
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        fk.flash_attention_bwd(*_bwd_args(**case))
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


def test_the_kernel_wrapper_refuses_mismatched_shapes():
    q, k, v, o, lse, do = _bwd_args()
    with pytest.raises(ValueError, match="shapes"):
        fk.flash_attention_bwd(q, k, v, o[:, :4], lse, do)
    with pytest.raises(ValueError, match="lse must be"):
        fk.flash_attention_bwd(q, k, v, o, lse[..., :4], do)
    with pytest.raises(ValueError, match="dtypes differ"):
        fk.flash_attention_bwd(q, k, v, o.half(), lse, do)


def test_bwd_flops_are_the_five_products():
    bh, s, hd = 64, 4096, 128
    qk = 2.0 * bh * s * s * hd / 2          # one causal S-sized product
    assert fk.bwd_flops(bh, s, s, hd) == 5 * qk == 2.5 * fk.flops(bh, s, s,
                                                                   hd)
    # the op walk still counts the op's forward by the kernel's FLOPs
    q = torch.empty(1, 4096, 2, 16, 128, device="meta")
    k = torch.empty(1, 4096, 2, 128, device="meta")
    assert fops.op_flops("flash_attention", (q, k, k, True)) == \
        fk.flops(32, 4096, 4096, 128)


def test_the_backward_kernels_op_has_a_fake_of_the_gradients_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(1, 40, 2, 3, 64, dtype=torch.bfloat16)
        k = torch.empty(1, 56, 2, 64, dtype=torch.bfloat16)
        lse = torch.empty(1, 2, 3, 40)
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, k, q, lse, q, True)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
