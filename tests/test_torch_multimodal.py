"""The VLM and encoder-decoder families — phi-3-vision-4.2b (576 patch
embeddings before the tokens at full size, 16 at the smoke size) and
seamless-m4t-large-v2 (an encoder over seq/8 frames, cross-attention in
every decoder block, ungated gelu, untied embeddings) — against the
reference on the same parameters.

Parameters and train states are made by the reference (PRNGKey 0) and
carried over by ``from_jax_numpy``; tokens, patch and frame embeddings
are drawn with numpy (the embeddings bf16, as the batch schema has
them).  The reference runs at ``fusion="off"`` with its flash route as
its plain ``_ref_gqa`` (``test_torch_attention.py``).  Tolerances are
``test_torch_moe.py``'s: logits O0 atol 1e-4, O1 6e-2 (read up to 0.055
on seamless, whose 256,256-column unembedding is cut to 512 at the smoke
size); loss rtol 1e-5 / 1e-2; the train step ``test_torch_train.py``'s;
decode the reference's logits within the same atol, bf16 caches one
bf16 rounding more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.configs import base as r_base
from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import get_smoke as r_get_smoke
from repro.kernels.flash_attention import ops as r_fa_ops
from repro.models import api as r_api
from repro.models import layers as r_layers
from repro.models import multimodal as r_mm
from repro.models import params as r_params
from repro.session import Session as RSession
from repro.train import step as r_step
from repro_torch import kernels
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_config as p_get_config
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.kernels.fused import ops as p_fops
from repro_torch.models import api as p_api
from repro_torch.models import layers as p_layers
from repro_torch.models import multimodal as p_mm
from repro_torch.models import transformer as p_tr
from repro_torch.models.params import from_jax_numpy
from repro_torch.session.session import Session
from repro_torch.train import step as p_step

from test_torch_decode import _np
from test_torch_train import LR, _compare

VLM, AUDIO = "phi-3-vision-4.2b", "seamless-m4t-large-v2"
ARCHS = (VLM, AUDIO)
TOL = {"O0": (1e-4, 1e-5), "O1": (6e-2, 1e-2)}
ROUTES = ("einsum", "chunked", "flash")


@pytest.fixture
def ref_flash_is_plain(monkeypatch):
    monkeypatch.setattr(
        r_fa_ops, "flash_attention_gqa",
        lambda q, k, v: r_fa_ops._ref_gqa(q, k, v, True))


def _params(arch: str):
    cfg = r_get_smoke(arch)
    return jax.tree.map(np.asarray, r_params.init(
        jax.random.PRNGKey(0), r_api.build(cfg).spec, jnp.float32))


def _batch(arch: str, kind: str, seed: int, batch: int = 2,
           seq: int = 32) -> dict:
    """numpy arrays with the reference's schema of a (seq, batch) cell:
    tokens in [0, vocab), float inputs normal × 0.02, rounded to bf16 and
    held as float32 (both packages read the same values)."""
    cfg = r_get_smoke(arch)
    schema = r_api.batch_schema(cfg, r_base.ShapeSpec("c", seq, batch, kind),
                                batch)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dt) in schema.items():
        if jnp.issubdtype(dt, jnp.integer):
            out[name] = rng.integers(0, cfg.vocab_size, shape, np.int32)
        else:
            out[name] = np.asarray(jnp.asarray(
                rng.standard_normal(shape, np.float32) * 0.02, dt),
                np.float32)
    return out


def _jax(b: dict) -> dict:
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                           else v.dtype) for k, v in b.items()}


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v).to(torch.bfloat16)
            if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    """Field for field at full and smoke size, ``param_count`` and
    ``active_param_count`` equal; the spec tree holds the count's leaves
    with the embeddings at the padded vocabulary, and (enc-dec) the
    encoder's final norm, which the reference's count leaves out."""
    from repro_torch.models.params import count
    for r_cfg, p_cfg in ((r_get_config(arch), p_get_config(arch)),
                         (r_get_smoke(arch), p_get_smoke(arch))):
        assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
        assert p_cfg.param_count() == r_cfg.param_count()
        assert p_cfg.active_param_count() == r_cfg.active_param_count() \
            == p_cfg.param_count()
        pad = (p_cfg.vocab_padded - p_cfg.vocab_size) * p_cfg.d_model * (
            1 if p_cfg.tie_embeddings else 2)
        enc_ln = p_cfg.d_model if p_cfg.n_encoder_layers else 0
        assert count(p_api.build(p_cfg).spec) == \
            p_cfg.param_count() + pad + enc_ln
    from repro_torch.configs import seamless_m4t_large_v2 as seamless
    assert seamless.FRAME_DOWNSAMPLE == p_tr.FRAME_DOWNSAMPLE == 8
    assert p_get_config(VLM).n_prefix_embeds == 576
    assert p_get_config(AUDIO).vocab_padded == 256_256


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch):
    r_leaves = jax.tree_util.tree_flatten_with_path(
        r_api.build(r_get_smoke(arch)).spec,
        is_leaf=lambda x: isinstance(x, r_params.P))[0]
    from repro_torch.models.params import leaves
    p_leaves = leaves(p_api.build(p_get_smoke(arch)).spec)
    assert [path for path, _ in p_leaves] == [
        "/".join(k.key for k in path) for path, _ in r_leaves]
    assert [tuple(p.shape) for _, p in p_leaves] == \
        [tuple(s.shape) for _, s in r_leaves]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_schema_matches_reference(arch, kind):
    """The VLM's tokens are seq − n_prefix_embeds long beside its
    ``prefix``; the enc-dec's ``frames`` (train, prefill) or ``memory``
    (decode) hold seq // 8 rows; float inputs bf16."""
    r_shape = r_base.ShapeSpec("cell", 64, 4, kind)
    p_shape = p_base.ShapeSpec("cell", 64, 4, kind)
    r = r_api.batch_schema(r_get_smoke(arch), r_shape, 2)
    p = p_api.batch_schema(p_get_smoke(arch), p_shape, 2)
    assert {k: (tuple(s), str(d).removeprefix("torch."))
            for k, (s, d) in p.items()} == \
        {k: (tuple(s), jnp.dtype(d).name) for k, (s, d) in r.items()}
    g = torch.Generator().manual_seed(0)
    batch = p_api.synthetic_batch(p_get_smoke(arch), p_shape, 2, g)
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
        {k: (tuple(s), d) for k, (s, d) in p.items()}
    for v in batch.values():
        if v.dtype.is_floating_point:
            assert 0.005 < float(v.float().std()) < 0.05
    assert p_api._token_lengths(p_get_smoke(arch), p_shape) == \
        r_api._token_lengths(r_get_smoke(arch), r_shape)


def test_prefix_stubs_match_reference():
    """``prefix_spec`` on meta with the reference's shape and dtype;
    ``synthetic_prefix`` a seeded normal × 0.02 of that shape."""
    cfg = p_get_smoke(VLM)
    spec = p_mm.prefix_spec(cfg, 3)
    r_spec = r_mm.prefix_spec(r_get_smoke(VLM), 3)
    assert spec.device.type == "meta"
    assert (tuple(spec.shape), str(spec.dtype).removeprefix("torch.")) == \
        (r_spec.shape, jnp.dtype(r_spec.dtype).name)
    a = p_mm.synthetic_prefix(cfg, 3, torch.Generator().manual_seed(1))
    b = p_mm.synthetic_prefix(cfg, 3, torch.Generator().manual_seed(1))
    assert a.shape == spec.shape and a.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0.015 < float(a.float().std()) < 0.025


# (amp, attn_impl, fusion): every route at O0, einsum at O1, and flash at
# O0 under ``static`` (the routed ops' plain versions on the host)
CASES = ([("O0", impl, "off") for impl in ROUTES]
         + [("O1", "einsum", "off"), ("O0", "flash", "static")])


@pytest.mark.parametrize("amp,impl,fusion", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(ref_flash_is_plain, arch, amp, impl,
                                         fusion):
    """Logits and loss at seq 32 (the VLM: 16 patches and 16 tokens, its
    logits over the tokens alone; seamless: 4 frames) under each route
    (``chunked`` at chunks of 16)."""
    r_cfg, p_cfg = r_get_smoke(arch), p_get_smoke(arch)
    params, b = _params(arch), _batch(arch, "train", 7)
    r_run = r_base.RunConfig(amp=amp, attn_impl=impl, attn_chunk=16)
    p_run = p_base.RunConfig(amp=amp, attn_impl=impl, attn_chunk=16,
                             fusion=fusion)
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_cfg)
    jp, jb = jax.tree.map(jnp.asarray, params), _jax(b)
    r_logits = jax.jit(lambda p, b: r_model.forward_fn(p, b, r_run))(jp, jb)
    r_loss = jax.jit(lambda p, b: r_model.loss_fn(p, b, r_run)[0])(jp, jb)
    tp, tb = from_jax_numpy(params), _torch(b)
    with torch.no_grad():
        p_logits = p_model.forward_fn(tp, tb, p_run)
        p_loss, p_met = p_model.loss_fn(tp, tb, p_run)
    assert tuple(p_logits.shape) == tuple(r_logits.shape) == (
        2, b["tokens"].shape[1], p_cfg.vocab_padded)
    atol, rtol = TOL[amp]
    np.testing.assert_allclose(p_logits.float().numpy(),
                               np.asarray(r_logits, np.float32), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=rtol)
    assert set(p_met) == {"loss", "ce"}


def test_cross_attention_matches_reference_and_never_takes_flash():
    """``attention_apply`` with ``memory`` against the reference's (O0):
    K/V from the memory, no RoPE, nothing masked; the result is the same
    under ``flash`` (the kernel is causal self-attention: cross-attention
    keeps the plain math, as the reference's) and the chunked route's
    flash seam refuses memory and caches."""
    cfg = r_get_smoke(AUDIO)
    p = jax.tree.map(np.asarray, r_params.init(
        jax.random.PRNGKey(3), r_layers.attention_spec(cfg), jnp.float32))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, cfg.d_model), np.float32)
    mem = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    want = r_layers.attention_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
        r_base.RunConfig(amp="O0"), causal=False, memory=jnp.asarray(mem))[0]
    tp = from_jax_numpy(p)
    for impl in ROUTES:
        run = p_base.RunConfig(amp="O0", attn_impl=impl, attn_chunk=16,
                               fusion="static")
        kernels.reset_launch_counts()
        with torch.no_grad():
            got = p_layers.attention_apply(
                tp, torch.from_numpy(x), p_get_smoke(AUDIO), run,
                causal=False, memory=torch.from_numpy(mem))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0, err_msg=impl)
    run = p_base.RunConfig(fusion="static")
    for kw in (dict(has_memory=True, has_cache=False),
               dict(has_memory=False, has_cache=True)):
        assert not p_fops.use_flash_from_chunked(
            run, (1, 2048, 4, 1, 16), (1, 2048, 4, 16), torch.bfloat16,
            causal=True, softmax_f32=True, chunk=1024, **kw)
    assert p_fops.use_flash_from_chunked(
        run, (1, 2048, 4, 1, 16), (1, 2048, 4, 16), torch.bfloat16,
        causal=True, has_memory=False, has_cache=False, softmax_f32=True,
        chunk=1024)


def test_flash_runs_every_causal_self_attention_and_no_cross():
    """Under ``flash`` the walk of seamless's fwd holds one flash op per
    encoder and decoder self-attention (the reference's encoder calls
    ``block_apply`` with the default ``causal=True``) and none for the
    decoder's cross-attentions; the VLM's one per layer over the whole
    sequence, patches included."""
    sess = Session(machine="cpu-host", device="cpu")
    for arch in ARCHS:
        cfg = p_get_smoke(arch)
        prof = sess.profile(arch, seq=32, batch=2, attn_impl="flash",
                            phases=("fwd",))
        n = sum(k.exec_count for k in prof.analyses["fwd"].kernels
                if k.opcode == "flash_attention")
        assert n == cfg.n_layers + cfg.n_encoder_layers, (arch, n)


def test_encoder_is_causal_as_the_reference():
    """The encoder's output at frame t does not depend on frames after t
    (the reference's encoder self-attention is causal and roped): changing
    the last frame changes only the last row of the memory."""
    cfg = p_get_smoke(AUDIO)
    tp = from_jax_numpy(_params(AUDIO))
    run = p_base.RunConfig(amp="O0")
    frames = torch.randn(1, 6, cfg.d_model, generator=torch.Generator()
                         .manual_seed(2)) * 0.02
    moved = frames.clone()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a = p_tr.encode(tp, frames, cfg, run)
        b = p_tr.encode(tp, moved, cfg, run)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=0)
    assert (a[:, -1] - b[:, -1]).abs().max() > 1e-3


_REF: dict = {}


def _reference_steps(arch: str, amp: str, batches):
    key = (arch, amp)
    if key not in _REF:
        run = r_base.RunConfig(amp=amp)
        model = r_api.build(r_get_smoke(arch))
        state = r_step.init_state(model, run, jax.random.PRNGKey(0))
        init_np = jax.tree.map(np.asarray, state)
        fn = jax.jit(r_step.make_train_step(model, run, lr=LR))
        out = []
        for b in batches:
            state, metrics = fn(state, _jax(b))
            out.append(jax.tree.map(np.asarray, (state, metrics)))
        _REF[key] = (init_np, out)
    return _REF[key]


@pytest.mark.parametrize("amp,fusion", [("O0", "off"), ("O1", "off"),
                                        ("O0", "static")])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, amp, fusion):
    """Three AdamW steps (batch 4, seq 32): loss, grad norm, params and
    both moments after steps 1 and 3; the encoder's leaves train through
    the cross-attention."""
    batches = [_batch(arch, "train", 30 + i, batch=4) for i in range(3)]
    init_np, ref_steps = _reference_steps(arch, amp, batches)
    model = p_api.build(p_get_smoke(arch))
    state = from_jax_numpy(init_np)
    step = p_step.make_train_step(model, p_base.RunConfig(
        amp=amp, fusion=fusion), lr=LR)
    for i, b in enumerate(batches):
        state, metrics = step(state, _torch(b))
        if i + 1 in (1, 3):
            _compare(state, metrics, *ref_steps[i], amp, i + 1)
    if arch == AUDIO:
        enc = state.params["enc_blocks"]["mlp"]["w_up"]
        assert not torch.equal(enc, from_jax_numpy(init_np).params[
            "enc_blocks"]["mlp"]["w_up"])


def _matmul(analysis) -> float:
    return sum(k.total_flops for k in analysis.kernels
               if k.category == "matmul")


@pytest.mark.parametrize("arch", ARCHS)
def test_phase_matmul_flops_match_reference_and_the_count(tmp_path, arch):
    """fwd, bwd and opt matmul FLOPs of the smoke step (seq 32, batch 4,
    O1) equal the reference's HLO walk, the fwd ``matmul_flops`` (the
    VLM's unembedding over its tokens only; seamless's encoder over 4
    frames and a cross-attention in each decoder layer)."""
    ref = RSession(machine="cpu-host", workspace=str(tmp_path)).profile(
        arch, seq=32, batch=4, amp="O1")
    port = Session(machine="cpu-host", device="cpu").profile(
        arch, seq=32, batch=4, amp="O1")
    got = {ph: _matmul(a) for ph, a in port.analyses.items()}
    assert got == {ph: _matmul(a) for ph, a in ref.analyses.items()}
    want = p_tr.matmul_flops(p_get_smoke(arch), 4, 32)
    assert got == {"fwd": want, "bwd": 3 * want, "opt": 0}


@pytest.mark.parametrize("arch,seq,batch", [(VLM, 2048, 2), (AUDIO, 2048, 2)])
def test_full_width_walk_counts_exactly_on_meta(arch, seq, batch):
    """The full-width, full-depth fwd walk on meta tensors: matmul FLOPs
    equal the count (phi-3: 576 patches in 2048 positions, the 32,064-
    column unembedding over 1472 tokens; seamless: 256 frames, 24 + 24
    layers, the 256,256-column unembedding)."""
    cfg = p_get_config(arch)
    prof = Session(machine="h100-sxm", device="cpu").profile(
        arch, smoke=False, seq=seq, batch=batch, phases=("fwd",))
    assert _matmul(prof.analyses["fwd"]) == p_tr.matmul_flops(cfg, batch,
                                                              seq)
    rows = seq - cfg.n_prefix_embeds
    assert [k for k in prof.analyses["fwd"].kernels
            if k.category == "matmul" and k.total_flops
            == 2 * batch * rows * cfg.d_model * cfg.vocab_padded]


def _decode_both(arch, amp, n_steps, memory=None):
    """``n_steps`` seeded tokens through both packages' ``decode_fn`` from
    a zero cache of 8 rows (batch 2), the enc-dec against ``memory``:
    the logits and both caches after every step."""
    r_cfg = r_get_smoke(arch)
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_get_smoke(arch))
    params = jax.tree.map(jnp.asarray, _params(arch))
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    r_run, p_run = r_base.RunConfig(amp=amp), p_base.RunConfig(amp=amp)
    spec = r_model.init_state_fn(2, 8)
    r_state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
    p_state = from_jax_numpy(jax.tree.map(np.asarray, r_state))
    extra_r = {} if memory is None else {"memory": jnp.asarray(
        memory, jnp.bfloat16)}
    extra_p = {} if memory is None else {"memory": torch.from_numpy(
        memory).to(torch.bfloat16)}
    step = jax.jit(lambda p, t, s: r_model.decode_fn(
        p, {"tokens": t, **extra_r}, s, r_run))
    rng = np.random.default_rng(11)
    atol = TOL[amp][0]
    for i in range(n_steps):
        tok = rng.integers(0, r_cfg.vocab_size, (2, 1), dtype=np.int32)
        r_logits, r_state = step(params, jnp.asarray(tok), r_state)
        with torch.no_grad():
            p_logits, p_state = p_model.decode_fn(
                tp, {"tokens": torch.from_numpy(tok), **extra_p}, p_state,
                p_run)
        np.testing.assert_allclose(_np(p_logits), _np(r_logits), atol=atol,
                                   rtol=0, err_msg=f"logits, step {i}")
        for a, b in zip(jax.tree.leaves(r_state),
                        tree_flatten(tuple(p_state))[0]):
            rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 0.0
            np.testing.assert_allclose(_np(b), _np(a), atol=atol, rtol=rtol,
                                       err_msg=f"state, step {i}")


@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, amp):
    """Ten steps: the VLM's ``decode_fn`` takes no prefix (after a
    prefill the patches sit in the cache); the enc-dec's attends an
    encoder output of 5 rows (``memory``) at every step."""
    memory = (np.asarray(jnp.asarray(np.random.default_rng(12)
                                     .standard_normal((2, 5, 64), np.float32),
                                     jnp.bfloat16), np.float32)
              if arch == AUDIO else None)
    _decode_both(arch, amp, 10, memory)


def test_encdec_decode_matches_the_forward():
    """The stepwise decode against the encoder's memory ≡ the forward over
    the same frames and tokens (O0, an fp32 cache): the KV cache against
    the causal einsum, the cross-attention the same at every step."""
    cfg = p_get_smoke(AUDIO)
    model = p_api.build(cfg)
    tp = from_jax_numpy(_params(AUDIO))
    run = p_base.RunConfig(amp="O0")
    b = _torch(_batch(AUDIO, "prefill", 5, batch=2, seq=16))
    T = b["tokens"].shape[1]
    state = model.init_state_fn(2, 32, torch.float32, device="cpu")
    outs = []
    with torch.no_grad():
        full = model.forward_fn(tp, b, run)
        memory = p_tr.encode(tp, b["frames"], cfg, run)
        for t in range(T):
            lg, state = model.decode_fn(
                tp, {"tokens": b["tokens"][:, t:t + 1], "memory": memory},
                state, run)
            outs.append(lg[:, 0])
    err = (torch.stack(outs, 1) - full).abs().max().item()
    assert err < 1e-4, err


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_reference(arch):
    shape = r_base.ShapeSpec("decode_cell", 64, 4, "decode")
    r = r_api.decode_state_specs(r_get_smoke(arch), shape)
    p = p_api.decode_state_specs(p_get_smoke(arch), p_base.ShapeSpec(
        "decode_cell", 64, 4, "decode"))
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_flatten(tuple(p))[0]] == \
        [(tuple(s.shape), jnp.dtype(s.dtype).name)
         for s in jax.tree.leaves(r)]
