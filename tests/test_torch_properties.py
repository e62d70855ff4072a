"""Property-based tests (hypothesis) over the port: the properties of the
reference's ``tests/test_properties.py``, at its ``max_examples``, on
``repro_torch``'s counterparts — int8 quantization with error feedback,
roofline math and the collective multipliers, tensor byte counts, the
loss's forms, RoPE's shift invariance, the paged KV pool against a
dense buffer, the data stream's determinism, and dispatch parity (the
impl a measurement picks against its reference route, value and
gradient).  Where a property has a reference counterpart that runs on
this jax, the drawn case is also held against it.
"""

from __future__ import annotations

import math
import tempfile

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.distributed import compression as R_CMP
from repro_torch.core.machine import H100_SXM
from repro_torch.core.op_analysis import _COLL_MULT, _nbytes
from repro_torch.core.roofline import attainable
from repro_torch.distributed.compression import (compress,
                                                 compress_with_feedback,
                                                 decompress)

SETTINGS = dict(max_examples=50, deadline=None)


class TestQuantization:
    @given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=1,
                    max_size=64))
    @settings(**SETTINGS)
    def test_roundtrip_error_bound(self, vals):
        """|x - deq(q(x))| ≤ scale/2 elementwise, and the payload is the
        reference's."""
        g = torch.tensor(vals, dtype=torch.float32)
        q, scale = compress(g)
        err = (g - decompress(q, scale)).abs()
        assert bool((err <= float(scale) / 2 + 1e-6).all())
        rq, _ = R_CMP.compress(jnp.asarray(np.asarray(vals, np.float32)))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))

    @given(st.integers(1, 40))
    @settings(**SETTINGS)
    def test_error_feedback_is_lossless_on_constant_stream(self, steps):
        """With error feedback the accumulated transmitted signal tracks
        the accumulated true signal (the error does not grow with T)."""
        g = torch.tensor([0.3, -0.007, 1.7])
        residual = torch.zeros_like(g)
        sent = torch.zeros_like(g)
        for _ in range(steps):
            q, scale, residual = compress_with_feedback(g, residual)
            sent = sent + decompress(q, scale)
        assert bool(((sent + residual - g * steps).abs() < 1e-4).all())

    @given(st.floats(1e-6, 1e6))
    @settings(**SETTINGS)
    def test_scale_invariance(self, s):
        g = torch.tensor([0.1, -0.9, 0.5])
        q1, _ = compress(g)
        q2, _ = compress(g * s)
        assert torch.equal(q1, q2)


class TestRooflineMath:
    @given(st.floats(1e-3, 1e6), st.sampled_from(["bf16", "f32", "int8"]))
    @settings(**SETTINGS)
    def test_attainable_never_exceeds_either_roof(self, ai, cls):
        a = attainable(ai, H100_SXM, cls)
        assert a <= H100_SXM.peak_for(cls) + 1e-6
        assert a <= H100_SXM.hbm.bytes_per_s * ai * (1 + 1e-9)

    @given(st.floats(1e-3, 1e5), st.floats(1.01, 10.0))
    @settings(**SETTINGS)
    def test_attainable_monotone_in_ai(self, ai, mult):
        assert attainable(ai * mult, H100_SXM) >= attainable(ai, H100_SXM)

    @given(st.integers(2, 4096))
    @settings(**SETTINGS)
    def test_collective_multipliers_bounded(self, n):
        """Ring wire factors: AR < 2, AG/RS/A2A < 1, AR = AG + RS, and the
        reference's HLO walk's."""
        from repro.core.hlo_analysis import _COLL_MULT as R_MULT
        assert 0 < _COLL_MULT["all-gather"](n) < 1
        assert 0 < _COLL_MULT["reduce-scatter"](n) < 1
        assert 1 <= _COLL_MULT["all-reduce"](n) < 2
        assert _COLL_MULT["all-reduce"](n) == (
            _COLL_MULT["all-gather"](n) + _COLL_MULT["reduce-scatter"](n))
        for op in ("all-gather", "reduce-scatter", "all-reduce",
                   "all-to-all"):
            assert _COLL_MULT[op](n) == R_MULT[op](n)


_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16, "s8": torch.int8, "s32": torch.int32,
           "f64": torch.float64, "pred": torch.bool, "s64": torch.int64}


class TestShapes:
    @given(st.sampled_from(sorted(_DTYPES)),
           st.lists(st.integers(1, 64), max_size=4))
    @settings(**SETTINGS)
    def test_tensor_bytes(self, dtype, dims):
        """The op walk's byte count of a tensor is the reference's HLO
        ``Shape.bytes`` of the same dtype and dims."""
        from repro.core.hlo_analysis import Shape
        t = torch.empty(tuple(dims), dtype=_DTYPES[dtype], device="meta")
        assert _nbytes(t) == Shape(dtype, tuple(dims)).bytes
        assert _nbytes(t) == int(np.prod(dims or [1])) * t.element_size()


class TestLossForms:
    @given(st.integers(2, 6), st.integers(3, 17))
    @settings(max_examples=20, deadline=None)
    def test_onehot_ce_equals_gather_ce(self, b, v):
        """The one-hot cross-entropy equals the gathered one."""
        from repro_torch.models.api import lm_loss
        gen = torch.Generator().manual_seed(b * 31 + v)
        logits = torch.randn(b, 4, v, generator=gen)
        targets = torch.randint(0, v, (b, 4), generator=gen)
        loss, _ = lm_loss(logits, targets)
        ref = -torch.log_softmax(logits, -1).gather(
            -1, targets[..., None]).mean()
        assert abs(float(loss) - float(ref)) < 1e-4

    @given(st.integers(1, 5))
    @settings(max_examples=10, deadline=None)
    def test_vocab_padding_invariance(self, pad_mult):
        """Masked padded columns do not change the loss."""
        from repro_torch.models.api import lm_loss
        gen = torch.Generator().manual_seed(pad_mult)
        v, vpad = 11, 11 + 3 * pad_mult
        logits = torch.randn(2, 4, v, generator=gen)
        padded = torch.cat([logits, torch.randn(2, 4, vpad - v,
                                                generator=gen) * 10], -1)
        targets = torch.randint(0, v, (2, 4), generator=gen)
        l1, _ = lm_loss(logits, targets)
        l2, _ = lm_loss(padded, targets, vocab=v)
        assert abs(float(l1) - float(l2)) < 1e-5


class TestRoPE:
    @given(st.integers(0, 64))
    @settings(max_examples=20, deadline=None)
    def test_rope_inner_products_are_shift_invariant(self, shift):
        """<rope(q,i), rope(k,j)> depends only on i - j."""
        from repro_torch.models.layers import rope
        q = torch.randn(1, 1, 1, 32, generator=torch.Generator()
                        .manual_seed(0))
        k = torch.randn(1, 1, 1, 32, generator=torch.Generator()
                        .manual_seed(1))

        def ip(i, j):
            return float(torch.sum(rope(q, torch.tensor([i]), 10_000.0)
                                   * rope(k, torch.tensor([j]), 10_000.0)))
        assert abs(ip(3 + shift, shift) - ip(3, 0)) < 1e-3


class TestPagedKV:
    """The paged KV pool against a dense buffer under random op
    sequences: any interleaving of appends and releases on any page size
    reads back what a contiguous buffer holds, and the allocator's books
    balance after every op."""

    N_SLOTS, MAX_LEN = 2, 12

    @given(page_size=st.integers(1, 5),
           ops=st.lists(
               st.tuples(st.sampled_from(["write", "release"]),
                         st.integers(0, N_SLOTS - 1), st.integers(1, 5)),
               max_size=10))
    @settings(max_examples=20, deadline=None)
    def test_roundtrip_vs_dense_reference(self, page_size, ops):
        from repro_torch.configs.registry import get_smoke
        from repro_torch.serve.paged_kv import PagedKVCache

        cfg = get_smoke("minitron-4b")
        cache = PagedKVCache(cfg, self.N_SLOTS, self.MAX_LEN,
                             page_size=page_size, device="cpu")
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        rng = np.random.default_rng(page_size)
        empty = np.zeros((L, 0, K, hd), np.float32)
        ref = {s: (empty, empty) for s in range(self.N_SLOTS)}

        for kind, slot, n in ops:
            start = ref[slot][0].shape[1]
            if kind == "write" and start + n <= self.MAX_LEN:
                k = rng.normal(size=(L, n, K, hd)).astype(np.float32)
                v = rng.normal(size=(L, n, K, hd)).astype(np.float32)
                cache.write(slot, start, torch.from_numpy(k),
                            torch.from_numpy(v))
                ref[slot] = (np.concatenate([ref[slot][0], k], axis=1),
                             np.concatenate([ref[slot][1], v], axis=1))
            elif kind == "release":
                cache.release(slot)
                ref[slot] = (empty, empty)
            cache.check()
            for s in range(self.N_SLOTS):
                n_tok = ref[s][0].shape[1]
                assert int(cache.lengths[s]) == n_tok
                got_k, got_v = cache.read(s, n_tok)
                for got, want in ((got_k, ref[s][0]), (got_v, ref[s][1])):
                    # the pool is bf16: exact against the bf16 cast
                    expect = torch.from_numpy(want).to(torch.bfloat16)
                    assert torch.equal(got, expect)

        used = sum(cache.pages_for(ref[s][0].shape[1])
                   for s in range(self.N_SLOTS))
        assert cache.n_used == used

    @given(st.integers(1, 5), st.integers(1, 12))
    @settings(**SETTINGS)
    def test_write_coords_cover_positions_exactly_once(self, page_size, n):
        """(page, offset) pairs of a fresh allocation are distinct, every
        token has a home, and positions past the pages map to -1."""
        from repro_torch.configs.registry import get_smoke
        from repro_torch.serve.paged_kv import PagedKVCache

        cache = PagedKVCache(get_smoke("minitron-4b"), 1, self.MAX_LEN,
                             page_size=page_size, device="cpu")
        n = min(n, self.MAX_LEN)
        assert cache.alloc(0, n)
        pages, offs = cache.write_coords(0, 0, cache.padded_len)
        live = [(int(p), int(o)) for p, o in zip(pages, offs) if p >= 0]
        assert len(live) == len(set(live))
        assert len(live) >= n
        assert all(0 <= o < page_size for _, o in live)
        allocated = cache.pages_for(n) * page_size
        assert all(int(p) == -1 for p in pages[allocated:])
        assert all(int(p) >= 0 for p in pages[:allocated])


class TestDataDeterminism:
    @given(st.integers(0, 1000))
    @settings(max_examples=20, deadline=None)
    def test_token_stream_pure_in_step(self, step):
        from repro.configs.base import ShapeSpec as RShape
        from repro.configs.registry import get_smoke as r_smoke
        from repro.data.pipeline import TokenStream as RStream
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.configs.registry import get_smoke
        from repro_torch.data.pipeline import TokenStream
        s = TokenStream(get_smoke("glm4-9b"), ShapeSpec("t", 16, 2, "train"),
                        2, seed=1)
        b1, b2 = s(step), s(step)
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k])
        if step > 0:
            b0 = s(step - 1)
            assert any(not np.array_equal(b0[k], b1[k]) for k in b1)
        # and the reference's stream, batch for batch
        r = RStream(r_smoke("glm4-9b"), RShape("t", 16, 2, "train"), 2,
                    seed=1)(step)
        assert sorted(r) == sorted(b1)
        for k in b1:
            np.testing.assert_array_equal(b1[k], r[k])


class TestDispatchParity:
    """Fused and reference are interchangeable at every dispatch site:
    whichever impl a measurement picks, value and gradient stay within
    the dtype's tolerance of the reference route (eligibility is the
    only correctness gate; routing is performance)."""

    @given(rows=st.sampled_from([1, 2, 7, 16]),
           d=st.sampled_from([16, 64]),
           dtype=st.sampled_from(["float32", "bfloat16"]),
           site=st.sampled_from(["rmsnorm", "swiglu"]),
           fused_wins=st.booleans())
    @settings(max_examples=20, deadline=None)
    def test_picked_impl_matches_reference_value_and_grad(
            self, rows, d, dtype, site, fused_wins):
        from repro_torch.kernels.fused import ops as fops
        from repro_torch.kernels.fused.norm import rmsnorm_ref
        from repro_torch.kernels.fused.swiglu import swiglu_ref
        from repro_torch.tune import dispatch as dsp
        from repro_torch.tune.store import TuneStore

        dt = getattr(torch, dtype)
        gen = torch.Generator().manual_seed(rows * d)
        a = torch.randn(rows, d, generator=gen).to(dt)
        b = torch.randn(rows, d, generator=gen).to(dt)
        s = torch.ones(d)

        if site == "rmsnorm":
            assert fops.norm_eligible(a, s)
            key = dsp.norm_key(a, s)
            fused = lambda x: fops.rmsnorm(x, s)
            ref = lambda x: rmsnorm_ref(x, s, 1e-5, dt)
        else:
            assert fops.swiglu_eligible(a, b)
            key = dsp.swiglu_key(a, b)
            fused = lambda x: fops.swiglu(x, b)
            ref = lambda x: swiglu_ref(x, b, "silu", dt)

        walls = ({"fused": 1e-3, "reference": 2e-3} if fused_wins
                 else {"fused": 2e-3, "reference": 1e-3})
        with tempfile.TemporaryDirectory() as tmp:
            store = TuneStore(f"{tmp}/tune.json")

            def timer(impl, fn, args, iters, warmup):
                return walls[impl]

            with dsp.dispatch_scope(store=store, mode="measure",
                                    timer=timer, device="cpu"):
                picked = dsp.decide(key)
        assert picked == ("fused" if fused_wins else "reference")
        impls = {"fused": fused, "reference": ref}

        def value_and_grad(f):
            x = a.clone().requires_grad_(True)
            loss = f(x).float().sum()
            (g,) = torch.autograd.grad(loss, x)
            return float(loss.detach()), g.float()

        tol = 1e-5 if dt == torch.float32 else 3e-2
        v_ref, g_ref = value_and_grad(impls["reference"])
        v_pick, g_pick = value_and_grad(impls[picked])
        assert math.isclose(v_pick, v_ref, rel_tol=tol,
                            abs_tol=tol * rows * d)
        torch.testing.assert_close(g_pick, g_ref, rtol=tol * 10,
                                   atol=tol * 10)
