"""The port's dense LM against the reference's, on the same parameters.

Parameters are initialised once by the reference (``init(PRNGKey(0),
spec)``), handed over as numpy arrays and converted by
``from_jax_numpy``; token batches are drawn with numpy.  Tolerances:

* O0 (fp32 everywhere): logits atol 1e-4, loss rtol 1e-5 — only the
  summation order of the fp32 contractions differs;
* O1 (bf16 compute, fp32 params and statistics): logits atol 5e-2, loss
  rtol 1e-2 — bf16 rounds intermediates at different places in the two
  frameworks (e.g. XLA may keep a fused elementwise chain in f32);
* the layer functions in fp32: atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs.registry import get_smoke as r_get_smoke
from repro.models import api as r_api
from repro.models import layers as r_layers
from repro.models import params as r_params
from repro.models import transformer as r_tr
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.models import api as p_api
from repro_torch.models import layers as p_layers
from repro_torch.models import params as p_params
from repro_torch.models import transformer as p_tr

# glm4's extreme grouping (32 query heads on 2 KV heads) at a narrow width,
# with a vocab that is not a multiple of 128 (the padded columns must be
# masked out of the loss) and tied embeddings (the unembed is tokens.T)
NARROW = dict(name="narrow-gqa", family="dense", n_layers=2, d_model=64,
              n_heads=32, n_kv_heads=2, head_dim=8, d_ff=96, vocab_size=300,
              act="swiglu", tie_embeddings=True)

CONFIGS = {
    "glm4-9b-smoke": (r_get_smoke("glm4-9b"), p_get_smoke("glm4-9b")),
    "narrow-gqa": (r_base.ModelConfig(**NARROW), p_base.ModelConfig(**NARROW)),
}
TOL = {"O0": (1e-4, 1e-5), "O1": (5e-2, 1e-2)}


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def model_pair(request):
    r_cfg, p_cfg = CONFIGS[request.param]
    r_model = r_api.build(r_cfg)
    params = r_params.init(jax.random.PRNGKey(0), r_model.spec, jnp.float32)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, r_cfg.vocab_size, (2, 16), dtype=np.int32)
    targets = rng.integers(0, r_cfg.vocab_size, (2, 16), dtype=np.int32)
    return r_cfg, p_cfg, r_model, params, tokens, targets


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_logits_and_loss_match_reference(model_pair, amp):
    r_cfg, p_cfg, r_model, params, tokens, targets = model_pair
    r_run, p_run = r_base.RunConfig(amp=amp), p_base.RunConfig(amp=amp)
    r_logits = jax.jit(lambda p, t: r_tr.forward(p, t, r_cfg, r_run)[0])(
        params, jnp.asarray(tokens))
    r_loss = jax.jit(lambda p, b: r_model.loss_fn(p, b, r_run)[0])(
        params, {"tokens": jnp.asarray(tokens),
                 "targets": jnp.asarray(targets)})

    p_model = p_api.build(p_cfg)
    tp = p_params.from_jax_numpy(_to_numpy(params))
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)}
    with torch.no_grad():
        p_logits = p_tr.forward(tp, batch["tokens"], p_cfg, p_run)
        p_loss = p_model.loss_fn(tp, batch, p_run)[0]

    atol, rtol = TOL[amp]
    assert p_logits.shape == r_logits.shape
    assert p_logits.dtype == (torch.float32 if amp == "O0" else torch.bfloat16)
    np.testing.assert_allclose(p_logits.float().numpy(),
                               np.asarray(r_logits, dtype=np.float32),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=rtol)
    assert np.isfinite(float(p_loss))


def test_padded_vocab_columns_are_masked():
    cfg = p_base.ModelConfig(**NARROW)
    assert cfg.vocab_padded == 384 > cfg.vocab_size
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 384)).astype(np.float32)
    targets = rng.integers(0, 300, (2, 5), dtype=np.int32)
    r_loss = r_api.lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                           jnp.zeros(()), 300)[0]
    p_loss = p_api.lm_loss(torch.from_numpy(logits),
                           torch.from_numpy(targets), 300)[0]
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=1e-6)
    # a huge logit in a padded column changes nothing
    logits[..., 350] = 1e4
    p_loss2 = p_api.lm_loss(torch.from_numpy(logits),
                            torch.from_numpy(targets), 300)[0]
    assert float(p_loss2) == float(p_loss)


@pytest.mark.parametrize("offset", [0, 5])
def test_rope_matches_reference(offset):
    rng = np.random.default_rng(offset)
    x = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32) + offset
    r = r_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    p = p_layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32) * 3
    h = rng.standard_normal((2, 16, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    r = r_layers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    p = p_layers.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                               torch.from_numpy(x))
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    rr, ry = r_layers.rmsnorm_residual_apply(
        {"scale": jnp.asarray(scale)}, jnp.asarray(x), jnp.asarray(h))
    pr, py = p_layers.rmsnorm_residual_apply(
        {"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
        torch.from_numpy(h))
    np.testing.assert_allclose(pr.numpy(), np.asarray(rr), atol=1e-6, rtol=0)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_matches_reference(causal):
    rng = np.random.default_rng(int(causal))
    q = rng.standard_normal((2, 16, 2, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    r = r_layers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(pos), jnp.asarray(pos), causal)
    p = p_layers._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(pos),
                       torch.from_numpy(pos), causal)
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_bf16_params_cross_exactly():
    r_cfg = r_get_smoke("glm4-9b")
    params = r_params.init(jax.random.PRNGKey(1), r_api.build(r_cfg).spec,
                           jnp.bfloat16)
    tp = p_params.from_jax_numpy(_to_numpy(params))
    r_leaf = params["blocks"]["attn"]["wq"]
    p_leaf = tp["blocks"]["attn"]["wq"]
    assert p_leaf.dtype == torch.bfloat16 and p_leaf.shape == r_leaf.shape
    np.testing.assert_array_equal(p_leaf.float().numpy(),
                                  np.asarray(r_leaf, dtype=np.float32))


def test_port_spec_tree_matches_reference():
    r_cfg, p_cfg = CONFIGS["glm4-9b-smoke"]
    r_shapes = jax.tree.map(lambda p: p.shape, r_api.build(r_cfg).spec,
                            is_leaf=lambda x: isinstance(x, r_params.P))
    p_shapes = p_params.tree_map_specs(lambda p: p.shape,
                                       p_api.build(p_cfg).spec)
    assert p_shapes == r_shapes
    assert p_params.count(p_api.build(p_cfg).spec) == r_params.count(
        r_api.build(r_cfg).spec)


def test_port_init_follows_reference_rules():
    spec = p_api.build(p_get_smoke("glm4-9b")).spec
    g = torch.Generator().manual_seed(0)
    params = p_params.init(spec, g, torch.float32)
    assert torch.equal(params["ln_f"]["scale"], torch.ones(64))
    wq = params["blocks"]["attn"]["wq"]             # (L, D, H, hd): fan-in L*D*H
    assert abs(wq.std().item() * np.sqrt(2 * 64 * 4) - 1) < 0.05
    emb = params["embed"]["tokens"]                  # small_normal
    assert abs(emb.std().item() - 0.02) < 0.002
    meta = p_params.init(spec, None, torch.bfloat16, "meta")
    assert meta["blocks"]["mlp"]["w_up"].device.type == "meta"
    assert meta["blocks"]["mlp"]["w_up"].dtype == torch.bfloat16


def test_config_copies_match_reference():
    import dataclasses
    r_cfg, p_cfg = CONFIGS["glm4-9b-smoke"]
    assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
    from repro.configs.registry import get_config as r_get_config
    from repro_torch.configs.registry import get_config as p_get_config
    full_r, full_p = r_get_config("glm4-9b"), p_get_config("glm4-9b")
    assert dataclasses.asdict(full_p) == dataclasses.asdict(full_r)
    assert full_p.param_count() == full_r.param_count()
    # the MoE family is ported: its config is the reference's too
    moe_r, moe_p = (r_get_config("granite-moe-1b-a400m"),
                    p_get_config("granite-moe-1b-a400m"))
    assert dataclasses.asdict(moe_p) == dataclasses.asdict(moe_r)
    assert moe_p.param_count() == moe_r.param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        p_get_config("granite-moe-2b")


@pytest.mark.parametrize("kw,exc", [
    # Adafactor and remat are ported: accepted, as the reference's
    ({"optimizer": "adafactor"}, None),
    # the measured dispatch table is ported: both names are accepted
    ({"fusion": "auto"}, None),
    ({"fusion": "measured"}, None),
    ({"remat": "dots"}, None),
    ({"remat": "full"}, None),
    ({"fusion": "bogus"}, ValueError),
    ({"amp": "O3"}, ValueError),
    ({"attn_impl": "bogus"}, ValueError),
    ({"attn_chunk": 0}, ValueError),
])
def test_run_config_refuses_what_this_slice_lacks(kw, exc):
    if exc is None:
        run, ref = p_base.RunConfig(**kw), r_base.RunConfig(**kw)
        for name, value in kw.items():
            assert getattr(run, name) == value == getattr(ref, name)
        return
    with pytest.raises(exc):
        p_base.RunConfig(**kw)


@pytest.mark.parametrize("amp", ["O0", "O1", "O2"])
def test_run_config_dtypes_match_reference(amp):
    r_run, p_run = r_base.RunConfig(amp=amp), p_base.RunConfig(amp=amp)
    assert str(p_run.param_dtype).removeprefix("torch.") == \
        jnp.dtype(r_run.param_dtype).name
    assert str(p_run.compute_dtype).removeprefix("torch.") == \
        jnp.dtype(r_run.compute_dtype).name
