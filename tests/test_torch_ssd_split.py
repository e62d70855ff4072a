"""The SSD kernel's decomposition (``ref.ssd_split``) against the reference.

``csrc/ssd.cu`` computes the chunked scan in passes: C·Bᵀ once per
(batch, chunk), each chunk's own state increment, an elementwise pass
over the chunks, then every chunk's output; each product on the tensor
cores in 3xTF32.  ``ref.ssd_split`` is that decomposition in plain
PyTorch, with a switch that rounds each product's operands as the tensor
cores take them.  Held here, on the host:

* against the JAX package's ``ssd_chunked`` (through its ``ssd_ref`` on
  the kernel layout), at ``kernel_tolerance`` (1e-4 of each (b, h, chunk)
  block's own max), in fp32 and with the 3xTF32 split, at the reference
  test shapes and chunks 16-256;
* at (1, 4, 1024, 64, 128, 256) against the scan in float64: the 3xTF32
  split passes with room, one TF32 product alone (10-bit operands) does
  not — the reason the kernel takes three;
* the increments and the pass against the reference's final state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_ref as r_ssd_ref
from repro.models.ssm import ssd_chunked as r_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel as p_kernel
from repro_torch.kernels.ssd_scan import ref

# (B, H, S, P, N, chunk): the reference's tests/test_kernels.py shapes
SHAPES = [(2, 3, 256, 16, 8, 64), (1, 2, 128, 32, 16, 32),
          (2, 1, 64, 8, 8, 64)]
LONG = (1, 4, 1024, 64, 128, 256)


def _inputs(seed: int, b, h, s, p, n):
    """x (B, H, S, P), a (B, H, S), B and C (B, S, N) as float32 numpy
    arrays, drawn as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, s, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, h, s))) * 0.1).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    return x, a, bm, cm


def _worst(got: torch.Tensor, want: torch.Tensor, chunk: int) -> float:
    """The largest |got - want| over its ``kernel_tolerance`` bound."""
    err = (got.double() - want.double()).abs()
    return (err / ref.kernel_tolerance(want, chunk).double()).max().item()


@pytest.mark.parametrize("tf32", [None, "3x"])
@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dims", SHAPES)
def test_split_matches_reference_within_the_kernel_tolerance(dims, chunk,
                                                             tf32):
    b, h, s, p, n, _ = dims
    arrs = _inputs(11, b, h, s, p, n)
    q = min(chunk, s)
    want = torch.from_numpy(np.array(
        r_ssd_ref(*(jnp.asarray(t) for t in arrs), chunk=q)))
    got = ref.ssd_split(*(torch.from_numpy(t) for t in arrs), chunk=q,
                        tf32=tf32)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _worst(got, want, q) <= 1.0


@pytest.fixture(scope="module")
def _long_case():
    """The long-chunk inputs and the scan on them in float64."""
    arrs = [torch.from_numpy(t) for t in _inputs(12, *LONG[:5])]
    want = ref.ssd_ref(*(t.double() for t in arrs), chunk=LONG[5])
    return arrs, want


def test_3xtf32_split_passes_at_the_long_chunk(_long_case):
    arrs, want = _long_case
    worst = _worst(ref.ssd_split(*arrs, chunk=LONG[5], tf32="3x"), want,
                   LONG[5])
    assert worst <= 0.1


def test_one_tf32_product_breaks_the_tolerance_at_the_long_chunk(
        _long_case):
    """One TF32 product keeps 10 bits of each operand: the error reaches
    several times ``REL_TOL`` of a block's max, so the kernel may not take
    the tensor cores' single pass."""
    arrs, want = _long_case
    worst = _worst(ref.ssd_split(*arrs, chunk=LONG[5], tf32="1x"), want,
                   LONG[5])
    assert worst > 2.0


@pytest.mark.parametrize("dims", SHAPES)
def test_increments_and_pass_give_the_reference_final_state(dims):
    """The state after the last chunk (what decoding reads) is the pass's
    last entering state carried over the last chunk's increment."""
    b, h, s, p, n, q = dims
    x, a, bm, cm = _inputs(13, b, h, s, p, n)
    _, want = jax.jit(lambda *t: r_ssd_chunked(*t, q))(
        jnp.asarray(x.transpose(0, 2, 1, 3)), jnp.asarray(a.transpose(0, 2, 1)),
        jnp.asarray(bm), jnp.asarray(cm))
    want = np.asarray(want)                             # (B, H, P, N)
    inc, total = ref.chunk_increments(torch.from_numpy(x),
                                      torch.from_numpy(a),
                                      torch.from_numpy(bm), q)
    states = ref.state_pass(inc, total)
    assert torch.equal(states[:, :, 0], torch.zeros_like(states[:, :, 0]))
    final = total[:, :, -1, None, None].exp() * states[:, :, -1] + inc[:, :, -1]
    np.testing.assert_allclose(final.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_chunk_cb_is_shared_by_the_heads_and_causal_where_read():
    b, h, s, p, n, q = SHAPES[0]
    _, _, bm, cm = _inputs(14, b, h, s, p, n)
    cb = ref.chunk_cb(torch.from_numpy(bm), torch.from_numpy(cm), q)
    assert cb.shape == (b, s // q, q, q)
    want = np.einsum("bcin,bcjn->bcij", cm.reshape(b, s // q, q, n),
                     bm.reshape(b, s // q, q, n))
    np.testing.assert_allclose(cb.numpy(), want, rtol=1e-5, atol=1e-6)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, one + 3 * 2 ** -12,
                      -(one + 2 ** -11), one + 2 ** -12, 0.0])
    assert ref.to_tf32(x).tolist() == [one, one + 2 ** -10, one + 2 ** -10,
                                       -(one + 2 ** -10), one, 0.0]
    with pytest.raises(ValueError, match="tf32"):
        ref.product(x[:, None], x[None, :], "2x")


@pytest.mark.parametrize("dims", [(2, 64, 2048, 64, 128, 256), *SHAPES,
                                  (1, 2, 192, 72, 20, 96)])
def test_executed_flops_follow_the_tiles(dims):
    """At least the needed work, and at the main shape the count walked
    out by hand: C·Bᵀ 10 tile pairs × 16 (batch, chunk); 7 increments of
    64 × 128 × 256 per (batch, head); 2176 keys × 16 rows × 64 columns per
    (batch, head, chunk), and 64 × 128 × 64 per tile in chunks after the
    first."""
    b, h, s, p, n, q = dims
    got = p_kernel.executed_flops(*dims)
    assert got >= p_kernel.needed_flops(*dims)
    if dims == (2, 64, 2048, 64, 128, 256):
        cb = 2 * 8 * 10 * 64 * 64 * 128
        inc = 2 * 64 * 7 * 64 * 128 * 256
        intra = 2 * 64 * 8 * 2176 * 16 * 64
        inter = 2 * 64 * 7 * 4 * 64 * 128 * 64
        assert got == 2.0 * (cb + inc + intra + inter) == 12_247_367_680


@pytest.mark.parametrize("dims", [(2, 64, 2048, 64, 128, 256), *SHAPES,
                                  (1, 2, 192, 72, 20, 96)])
def test_scratch_starts_each_array_16_byte_aligned(dims):
    b, h, s, p, n, q = dims
    cb, states, totals = p_kernel.scratch_floats(b, s, h, p, n, q)
    qp = -(-q // 64) * 64
    assert (cb, states, totals) == (b * (s // q) * qp * qp,
                                    b * h * (s // q) * p * n,
                                    b * h * (s // q))
    assert cb % 4 == 0 and states % 4 == 0
