"""The port's ``chunked`` and ``flash`` attention routes against the
reference's, in the model and in the train step.

The reference's flash route runs its Pallas kernel, which this jax cannot
compile; the tests replace ``repro.kernels.flash_attention.ops.
flash_attention_gqa`` with its plain reference ``_ref_gqa(q, k, v, True)``
— what its ``custom_vjp`` computes in both directions.  The port runs its
own route (the flash op's plain version on the CPU).  Parameters come
from the reference (``init`` / ``init_state`` with PRNGKey 0) through
``from_jax_numpy``, a fresh copy for every run; tokens are drawn with
numpy.  Tolerances are those of ``test_torch_model.py`` (logits, loss)
and ``test_torch_train.py`` (train step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs.registry import get_smoke as r_get_smoke
from repro.kernels.flash_attention import ops as r_fa_ops
from repro.models import api as r_api
from repro.models import params as r_params
from repro.models import transformer as r_tr
from repro.train import step as r_step
from repro_torch import kernels
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.models import api as p_api
from repro_torch.models import transformer as p_tr
from repro_torch.models.params import from_jax_numpy
from repro_torch.train import step as p_step

from test_torch_train import LR, _batches, _compare

TOL = {"O0": (1e-4, 1e-5), "O1": (5e-2, 1e-2)}
# (attn_impl, attn_chunk, fusion); at S = 32 a chunk of 16 makes the
# chunked path run (S > chunk, S % chunk == 0); under fusion it takes the
# flash route (eligible: 32 divides into 32-wide blocks >= 16)
ROUTES = [("flash", 1024, "off"), ("flash", 1024, "static"),
          ("chunked", 16, "off"), ("chunked", 16, "static")]


@pytest.fixture
def ref_flash_is_plain(monkeypatch):
    monkeypatch.setattr(
        r_fa_ops, "flash_attention_gqa",
        lambda q, k, v: r_fa_ops._ref_gqa(q, k, v, True))


@pytest.fixture(scope="module")
def smoke():
    r_cfg, p_cfg = r_get_smoke("glm4-9b"), p_get_smoke("glm4-9b")
    params = r_params.init(jax.random.PRNGKey(0), r_api.build(r_cfg).spec,
                           jnp.float32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, r_cfg.vocab_size, (2, 32), dtype=np.int32)
    targets = rng.integers(0, r_cfg.vocab_size, (2, 32), dtype=np.int32)
    return (r_cfg, p_cfg, jax.tree.map(np.asarray, params), tokens,
            targets)


@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("impl,chunk,fusion", ROUTES)
def test_logits_and_loss_match_reference(smoke, ref_flash_is_plain, impl,
                                         chunk, fusion, amp):
    r_cfg, p_cfg, params_np, tokens, targets = smoke
    # the reference at fusion "off": its fused Pallas kernels need a TPU
    # compiler option this jax lacks; its chunked route only reaches the
    # flash kernel under fusion, so that case runs the flash route
    r_impl = "flash" if (impl, fusion) == ("chunked", "static") else impl
    r_run = r_base.RunConfig(amp=amp, attn_impl=r_impl, attn_chunk=chunk)
    p_run = p_base.RunConfig(amp=amp, attn_impl=impl, attn_chunk=chunk,
                             fusion=fusion)
    params = jax.tree.map(jnp.asarray, params_np)
    r_model = r_api.build(r_cfg)
    r_logits = jax.jit(lambda p, t: r_tr.forward(p, t, r_cfg, r_run)[0])(
        params, jnp.asarray(tokens))
    r_loss = jax.jit(lambda p, b: r_model.loss_fn(p, b, r_run)[0])(
        params, {"tokens": jnp.asarray(tokens),
                 "targets": jnp.asarray(targets)})

    tp = from_jax_numpy(params_np)
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)}
    with torch.no_grad():
        p_logits = p_tr.forward(tp, batch["tokens"], p_cfg, p_run)
        p_loss = p_api.build(p_cfg).loss_fn(tp, batch, p_run)[0]
    atol, rtol = TOL[amp]
    np.testing.assert_allclose(p_logits.float().numpy(),
                               np.asarray(r_logits, dtype=np.float32),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=rtol)
    assert np.isfinite(float(p_loss))


def _walk(impl: str, chunk: int, fusion: str):
    cfg = p_get_smoke("glm4-9b")
    model = p_api.build(cfg)
    run = p_base.RunConfig(amp="O1", attn_impl=impl, attn_chunk=chunk,
                           fusion=fusion)
    params = from_jax_numpy(jax.tree.map(np.asarray, r_params.init(
        jax.random.PRNGKey(0), r_api.build(r_get_smoke("glm4-9b")).spec,
        jnp.float32)))
    tokens = torch.zeros((2, 32), dtype=torch.int32)
    return cfg, analyze_fn(lambda p, t: model.forward_fn(
        p, {"tokens": t}, run), (params, tokens))


@pytest.mark.parametrize("impl,chunk,fusion", ROUTES)
def test_each_route_reaches_the_op_it_should(impl, chunk, fusion):
    """flash, and chunked under fusion, give one flash record per layer;
    chunked without fusion gives none, and keeps every attention matmul."""
    cfg, ana = _walk(impl, chunk, fusion)
    flash = [k for k in ana.kernels if k.opcode == "flash_attention"]
    mm = sum(k.total_flops for k in ana.kernels if k.category == "matmul")
    B, S, H, hd = 2, 32, cfg.n_heads, cfg.head_dim
    qk_pv = 4 * B * H * S * S * hd * cfg.n_layers
    if (impl, fusion) == ("chunked", "off"):
        assert not flash
        assert mm == p_tr.matmul_flops(cfg, B, S)
    else:
        (rec,) = flash
        assert rec.exec_count == cfg.n_layers
        assert mm == p_tr.matmul_flops(cfg, B, S) - qk_pv
        assert rec.total_flops == qk_pv / 2


def test_every_route_runs_on_the_host_without_a_launch():
    """The routed flash op is the only way the model reaches the kernel's
    counter; on the CPU the counter stays 0 on every route."""
    kernels.reset_launch_counts()
    cfg = p_get_smoke("glm4-9b")
    tokens = torch.zeros((1, 32), dtype=torch.int64)
    for impl, chunk, fusion in ROUTES:
        params = from_jax_numpy(jax.tree.map(np.asarray, r_params.init(
            jax.random.PRNGKey(0), r_api.build(r_get_smoke("glm4-9b")).spec,
            jnp.float32)))
        run = p_base.RunConfig(amp="O0", attn_impl=impl, attn_chunk=chunk,
                               fusion=fusion)
        with torch.no_grad():
            assert torch.isfinite(p_tr.forward(params, tokens, cfg,
                                               run)).all()
    assert kernels.launch_counts()["flash_attention"] == 0


_REF: dict = {}


def _reference_steps(amp: str):
    if amp not in _REF:
        run = r_base.RunConfig(amp=amp, attn_impl="flash")
        model = r_api.build(r_get_smoke("glm4-9b"))
        state = r_step.init_state(model, run, jax.random.PRNGKey(0))
        init_np = jax.tree.map(np.asarray, state)
        fn = jax.jit(r_step.make_train_step(model, run, lr=LR))
        out = []
        for b in _batches(3):
            state, metrics = fn(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            out.append(jax.tree.map(np.asarray, (state, metrics)))
        _REF[amp] = (init_np, out)
    return _REF[amp]


@pytest.mark.parametrize("amp,fusion", [("O0", "off"), ("O0", "static"),
                                        ("O1", "static")])
def test_train_step_at_flash_matches_reference(ref_flash_is_plain, amp,
                                               fusion):
    init_np, ref_steps = _reference_steps(amp)
    run = p_base.RunConfig(amp=amp, attn_impl="flash", fusion=fusion)
    model = p_api.build(p_get_smoke("glm4-9b"))
    state = from_jax_numpy(init_np)
    step = p_step.make_train_step(model, run, lr=LR)
    for i, b in enumerate(_batches(3)):
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i + 1 in (1, 3):
            r_state, r_metrics = ref_steps[i]
            _compare(state, metrics, r_state, r_metrics, amp, i + 1)
