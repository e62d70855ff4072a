"""The port's decode steps against the reference's, on the same parameters
and the same decode state.

Parameters and states are made by the reference (``init(PRNGKey(0),
spec)``; a state from its ``init_state_fn``'s shapes, zeros or a seeded
numpy draw), handed over as numpy arrays and converted by
``from_jax_numpy``; tokens are drawn with numpy.  Each step's logits and
every leaf of the new state are held at ``test_torch_model.TOL``'s logits
tolerance (O0 atol 1e-4: fp32 sums in another order; O1 atol 5e-2: bf16
rounds intermediates at other places), a bf16 leaf (the KV caches) within
one bf16 rounding more (rtol 2^-7).  The stepwise-against-forward
duality of the port alone is held at the reference's own bounds
(``tests/test_models.py``): 5e-3 for the dense KV cache, 5e-2 where the
SSD recurrence replaces the chunked scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.configs import base as r_base
from repro.configs.registry import get_smoke as r_get_smoke
from repro.models import api as r_api
from repro.models import hybrid as r_hybrid
from repro.models import layers as r_layers
from repro.models import params as r_params
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.models import api as p_api
from repro_torch.models import hybrid as p_hybrid
from repro_torch.models import layers as p_layers
from repro_torch.models.params import from_jax_numpy
from test_torch_model import TOL

ARCHS = {"dense": "glm4-9b", "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b"}
# the reference's duality bounds (tests/test_models.py:152, :171)
DUALITY_TOL = {"dense": 5e-3, "ssm": 5e-2, "hybrid": 5e-2}


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    arch = ARCHS[request.param]
    r_cfg, p_cfg = r_get_smoke(arch), p_get_smoke(arch)
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_cfg)
    params = r_params.init(jax.random.PRNGKey(0), r_model.spec, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    return request.param, r_cfg, p_cfg, r_model, p_model, params, tp


def _zeros(spec):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)


def _random(spec, seed):
    """The reference's state shapes filled from a seeded numpy draw (the
    fill left as it is)."""
    rng = np.random.default_rng(seed)

    def one(s):
        if jnp.issubdtype(s.dtype, jnp.integer):
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(rng.standard_normal(s.shape, np.float32) * 0.5,
                           s.dtype)
    return jax.tree.map(one, spec)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _step_both(r_model, p_model, params, tp, r_state, amp, n_steps,
               vocab, batch, seed=0):
    """Decode ``n_steps`` seeded tokens through both packages from the same
    state, holding the logits and every state leaf after each step."""
    r_run, p_run = r_base.RunConfig(amp=amp), p_base.RunConfig(amp=amp)
    atol = TOL[amp][0]
    p_state = from_jax_numpy(jax.tree.map(np.asarray, r_state))
    step = jax.jit(lambda p, t, s: r_model.decode_fn(p, {"tokens": t}, s,
                                                     r_run))
    rng = np.random.default_rng(seed)
    for i in range(n_steps):
        tok = rng.integers(0, vocab, (batch, 1), dtype=np.int32)
        r_logits, r_state = step(params, jnp.asarray(tok), r_state)
        with torch.no_grad():
            p_logits, p_state = p_model.decode_fn(
                tp, {"tokens": torch.from_numpy(tok)}, p_state, p_run)
        assert p_logits.shape == r_logits.shape
        np.testing.assert_allclose(_np(p_logits), _np(r_logits), atol=atol,
                                   rtol=0, err_msg=f"logits, step {i}")
        r_leaves = jax.tree.leaves(r_state)
        p_leaves = tree_flatten(tuple(p_state))[0]
        assert len(p_leaves) == len(r_leaves)
        for j, (a, b) in enumerate(zip(r_leaves, p_leaves)):
            assert tuple(b.shape) == a.shape
            assert str(b.dtype).removeprefix("torch.") == \
                jnp.dtype(a.dtype).name
            # a bf16 leaf (a KV cache) stores a rounding of values that
            # may differ in their last bits: one bf16 ulp more
            rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 0.0
            np.testing.assert_allclose(_np(b), _np(a), atol=atol, rtol=rtol,
                                       err_msg=f"state leaf {j}, step {i}")
    return r_state, p_state


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_decode_step_matches_reference(pair, amp):
    """Zero state, 10 steps: the dense cache (8 rows: the last two steps'
    per-row writes fall past it and are dropped, the fill masks nothing),
    the SSM's recurrent state, the hybrid's window of 4 (wrapping twice)."""
    kind, r_cfg, _, r_model, p_model, params, tp = pair
    if kind == "dense":
        spec = r_model.init_state_fn(2, 8)
    elif kind == "hybrid":
        spec = r_hybrid.init_state(r_cfg, 2, 4)
    else:
        spec = r_model.init_state_fn(2)
    _step_both(r_model, p_model, params, tp, _zeros(spec), amp, 10,
               r_cfg.vocab_size, 2)


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_dense_per_row_lengths_and_drop(amp):
    """Continuous batching's per-row fill: two rows at fills 1 and 5 of a
    random 8-row cache; row 1 runs past the cache after three steps, where
    the reference's ``mode="drop"`` scatter leaves it unwritten."""
    r_cfg, p_cfg = r_get_smoke("glm4-9b"), p_get_smoke("glm4-9b")
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_cfg)
    params = r_params.init(jax.random.PRNGKey(2), r_model.spec, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    state = _random(r_model.init_state_fn(2, 8), seed=3)
    state = state._replace(length=jnp.asarray([1, 5], jnp.int32))
    r_state, p_state = _step_both(r_model, p_model, params, tp, state, amp,
                                  5, r_cfg.vocab_size, 2, seed=4)
    assert p_state.length.tolist() == [6, 10]
    # row 1 wrote rows 5..7 and nothing else
    np.testing.assert_array_equal(_np(p_state.k[:, 1, :5]),
                                  _np(state.k[:, 1, :5]))


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_dense_scalar_length_clamps_at_a_full_cache(amp):
    """An aligned batch's scalar fill: from 6 of 8 rows, 4 steps; the last
    two start past the cache, where the reference's
    ``dynamic_update_slice`` clamps the start and overwrites row 7."""
    r_cfg, p_cfg = r_get_smoke("glm4-9b"), p_get_smoke("glm4-9b")
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_cfg)
    params = r_params.init(jax.random.PRNGKey(2), r_model.spec, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    state = _random(r_model.init_state_fn(2, 8), seed=5)
    state = state._replace(length=jnp.asarray(6, jnp.int32))
    r_state, p_state = _step_both(r_model, p_model, params, tp, state, amp,
                                  4, r_cfg.vocab_size, 2, seed=6)
    assert p_state.length.dim() == 0 and int(p_state.length) == 10
    # rows 0..5 untouched: the clamped writes all land in row 7
    np.testing.assert_array_equal(_np(p_state.k[:, :, :6]),
                                  _np(state.k[:, :, :6]))


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_hybrid_decode_across_the_window_wrap(amp):
    """zamba2 smoke with a window of 8 over 12 steps from a random state:
    past the wrap the write slot is ``length % 8``, the RoPE position is
    clamped to 7 and the site attends only rows ``0 .. slot``."""
    r_cfg, p_cfg = r_get_smoke("zamba2-1.2b"), p_get_smoke("zamba2-1.2b")
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_cfg)
    params = r_params.init(jax.random.PRNGKey(1), r_model.spec, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    state = _random(r_hybrid.init_state(r_cfg, 2, 8), seed=7)
    r_state, p_state = _step_both(r_model, p_model, params, tp, state, amp,
                                  12, r_cfg.vocab_size, 2, seed=8)
    assert p_state.length.tolist() == [12, 12]
    assert p_state.attn_k.shape[2] == 8


def test_decode_matches_forward(pair):
    """The port's stepwise decode from a zero state ≡ its forward over
    the same tokens (O0): the KV cache against the causal einsum, the SSD
    recurrence against the chunked scan (the SSD duality)."""
    kind, r_cfg, p_cfg, _, p_model, _, tp = pair
    run = p_base.RunConfig(amp="O0")
    T = 12
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, p_cfg.vocab_size, (1, T), dtype=np.int32))
    state = p_model.init_state_fn(1, 32, torch.float32, device="cpu") \
        if kind != "ssm" else p_model.init_state_fn(1, device="cpu")
    outs = []
    with torch.no_grad():
        full = p_model.forward_fn(tp, {"tokens": tokens}, run)
        for t in range(T):
            lg, state = p_model.decode_fn(tp, {"tokens": tokens[:, t:t + 1]},
                                          state, run)
            outs.append(lg[:, 0])
    err = (torch.stack(outs, 1) - full).abs().max().item()
    assert err < DUALITY_TOL[kind], err


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_batch_schema_matches_reference(arch, kind):
    r_shape = r_base.ShapeSpec("cell", 64, 4, kind)
    p_shape = p_base.ShapeSpec("cell", 64, 4, kind)
    r = r_api.batch_schema(r_get_smoke(arch), r_shape, 2)
    p = p_api.batch_schema(p_get_smoke(arch), p_shape, 2)
    assert {k: (tuple(s), str(d).removeprefix("torch."))
            for k, (s, d) in p.items()} == \
        {k: (tuple(s), jnp.dtype(d).name) for k, (s, d) in r.items()}
    batch = p_api.synthetic_batch(p_get_smoke(arch), p_shape, 2, None,
                                  "meta")
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(s) for k, (s, _) in r.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_decode_state_specs_match_reference(arch):
    """The decode cell's state (a cache of seq_len, a scalar fill) as meta
    tensors with the reference's shapes and dtypes, leaf for leaf."""
    shape = r_base.ShapeSpec("decode_cell", 64, 4, "decode")
    r = r_api.decode_state_specs(r_get_smoke(arch), shape)
    p = p_api.decode_state_specs(p_get_smoke(arch), p_base.ShapeSpec(
        "decode_cell", 64, 4, "decode"))
    assert type(p).__name__ == type(r).__name__ and p._fields == r._fields
    r_leaves = jax.tree.leaves(r)
    p_leaves = tree_flatten(tuple(p))[0]
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in p_leaves] == \
        [(tuple(s.shape), jnp.dtype(s.dtype).name) for s in r_leaves]
    assert all(t.device.type == "meta" for t in p_leaves)


def test_init_state_allocates_on_the_device_asked_for():
    cfg = p_get_smoke("zamba2-1.2b")
    model = p_api.build(cfg)
    meta = model.init_state_fn(2, 16)
    host = model.init_state_fn(2, 16, device="cpu")
    assert meta.attn_k.device.type == "meta"
    assert host.attn_k.device.type == "cpu" and not host.attn_k.any()
    assert host.attn_k.shape[2] == 16 and host.length.tolist() == [0, 0]
    # the window is capped at ATTN_WINDOW
    assert model.init_state_fn(1, 10 ** 6).attn_k.shape[2] == \
        p_hybrid.ATTN_WINDOW == r_hybrid.ATTN_WINDOW


@pytest.mark.parametrize("per_row", [False, True])
def test_sdpa_k_len_matches_reference(per_row):
    rng = np.random.default_rng(int(per_row))
    q = rng.standard_normal((2, 3, 2, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    k_len = np.array([5, 16], np.int32) if per_row else np.array(7, np.int32)
    r = r_layers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.arange(3), jnp.asarray(pos), False,
                       k_len=jnp.asarray(k_len))
    p = p_layers._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.arange(3),
                       torch.from_numpy(pos), False,
                       k_len=torch.from_numpy(k_len))
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["scalar", "scalar_past_the_end", "per_row",
                                  "several_tokens"])
def test_attention_with_a_cache_matches_reference(case):
    """``attention_apply`` with a KV cache, each of the reference's three
    writes (``layers.cache_update``), fp32 at the layer functions' atol
    1e-5: a scalar fill (and one past the end, which clamps onto the last
    row), per-row fills (one past the end: dropped), and several tokens
    at once (the one-hot blend, S = S_max)."""
    r_cfg, p_cfg = r_get_smoke("glm4-9b"), p_get_smoke("glm4-9b")
    params = r_params.init(jax.random.PRNGKey(4),
                           r_layers.attention_spec(r_cfg), jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    B, S_max, K, hd = 2, 8, r_cfg.n_kv_heads, r_cfg.head_dim
    rng = np.random.default_rng(10)
    S = S_max if case == "several_tokens" else 1
    idx = {"scalar": np.array(4, np.int32),
           "scalar_past_the_end": np.array(9, np.int32),
           "per_row": np.array([3, 9], np.int32),
           "several_tokens": np.array([2, 5], np.int32)}[case]
    pos = (np.arange(S, dtype=np.int32) if S > 1 else
           idx[:, None] if idx.ndim else idx.reshape(1, 1))
    x = rng.standard_normal((B, S, r_cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, S_max, K, hd)).astype(np.float32)
              for _ in range(2))
    r_y, (r_k, r_v) = r_layers.attention_apply(
        params, jnp.asarray(x), r_cfg, r_base.RunConfig(amp="O0"),
        positions=jnp.asarray(pos), kv_cache=(jnp.asarray(ck),
                                              jnp.asarray(cv)),
        cache_len=jnp.asarray(idx))
    p_y, (p_k, p_v) = p_layers.attention_apply(
        tp, torch.from_numpy(x), p_cfg, p_base.RunConfig(amp="O0"),
        positions=torch.from_numpy(pos),
        kv_cache=(torch.from_numpy(ck), torch.from_numpy(cv)),
        cache_len=torch.from_numpy(idx))
    for p, r in ((p_y, r_y), (p_k, r_k), (p_v, r_v)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)
    if case == "per_row":            # row 1's write fell past the cache
        np.testing.assert_array_equal(p_k[1].numpy(), ck[1])
