"""The port's train step against the reference's, from the same state.

The reference's ``init_state`` (PRNGKey 0) is handed over as numpy arrays
and converted by ``from_jax_numpy`` (params, AdamW moments and count, loss
scale); token batches are drawn with numpy.  The port runs at
``fusion="off"`` and ``"static"`` (on the CPU the fused ops run their
plain versions), the reference at ``fusion="off"`` — its Pallas kernels
need a TPU compiler option this jax lacks, and its fused math is the
same function.  Checked after step 1 and step 3.  Tolerances:

* O0 (fp32 everywhere): loss and grad-norm rtol 1e-5; params atol 2e-5
  (AdamW's early steps are close to lr·sign(g), so a fp32 summation-order
  difference in a near-zero gradient moves a weight by a little more
  than it moves the gradient); moments within 1e-5 of their norm;
* O1 / O2 (bf16 compute): loss and grad-norm rtol 1e-2, moments within
  5e-2 of their norm — bf16 rounds intermediates at different places in
  the two frameworks (as in ``test_torch_model.py``), and the gradients
  inherit that; params atol 2·lr per step (an update of size up to lr
  may flip sign where a gradient is near zero), plus one bf16 spacing
  below 1.0 (2^-8) under O2, whose params are stored in bf16;
* count, loss scale, good steps and ``grads_finite`` exactly.
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
from repro.train import optim as r_optim
from repro.train import step as r_step
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.distributed import amp as p_amp
from repro_torch.models import api as p_api
from repro_torch.models.params import from_jax_numpy
from repro_torch.train import optim as p_optim
from repro_torch.train import step as p_step

LR = 3e-4
STEPS = 3
TOL = {  # loss/grad-norm rtol, moment norm-relative error, params atol/step
    "O0": (1e-5, 1e-5, None),
    "O1": (1e-2, 5e-2, 2 * LR),
    "O2": (1e-2, 5e-2, 2 * LR),
}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _batches(n: int, vocab: int = 512) -> list[dict]:
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, vocab, (4, 32), dtype=np.int32)
             for k in ("tokens", "targets")} for _ in range(n)]


def _norm_rel(p: torch.Tensor, r) -> float:
    a, b = _f32(p), _f32(r)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


_REF: dict = {}


def _reference(amp: str, mb: int):
    """(initial state as numpy, [(state, metrics) after each step]) of the
    reference, computed once per (amp, microbatches)."""
    key = (amp, mb)
    if key not in _REF:
        run = r_base.RunConfig(amp=amp, microbatches=mb)
        model = r_api.build(r_get_smoke("glm4-9b"))
        state = r_step.init_state(model, run, jax.random.PRNGKey(0))
        init_np = jax.tree.map(np.asarray, state)
        fn = jax.jit(r_step.make_train_step(model, run, lr=LR))
        out = []
        for b in _batches(STEPS):
            state, metrics = fn(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            out.append(jax.tree.map(np.asarray, (state, metrics)))
        _REF[key] = (init_np, out)
    return _REF[key]


def _compare(p_state, p_metrics, r_state, r_metrics, amp: str,
             steps: int, mom_tol_of=None, kink_share: float = 0.0) -> None:
    """``mom_tol_of(leaf path, tolerance)`` may state a moment tolerance
    per leaf (its caller says why); by default every leaf takes TOL's.
    ``kink_share`` (default 0: none) lets at most that share of a leaf's
    elements pass the params tolerance, each within 2·lr a step: its
    caller says why."""
    rtol, mom_tol, patol = TOL[amp]
    np.testing.assert_allclose(float(p_metrics["loss"]),
                               float(r_metrics["loss"]), rtol=rtol)
    np.testing.assert_allclose(float(p_metrics["ce"]),
                               float(r_metrics["ce"]), rtol=rtol)
    np.testing.assert_allclose(float(p_metrics["grad_norm"]),
                               float(r_metrics["grad_norm"]), rtol=rtol)
    assert float(p_metrics["grads_finite"]) == \
        float(r_metrics["grads_finite"]) == 1.0
    atol = 2e-5 if patol is None else (
        patol * steps + (2.0 ** -8 if amp == "O2" else 0.0))
    p_params = tree_flatten(p_state.params)[0]
    r_params = jax.tree.leaves(r_state.params)
    assert len(p_params) == len(r_params)
    for p, r in zip(p_params, r_params):
        assert str(p.dtype).removeprefix("torch.") == r.dtype.name
        if kink_share:
            d = np.abs(_f32(p) - _f32(r))
            assert (d > atol).sum() <= kink_share * d.size, (d > atol).sum()
            assert d.max(initial=0.0) <= 2 * LR * steps, d.max()
        else:
            np.testing.assert_allclose(_f32(p), _f32(r), atol=atol, rtol=0)
    for name in ("mu", "nu"):
        for p, (path, r) in zip(
                tree_flatten(getattr(p_state.opt, name))[0],
                jax.tree_util.tree_flatten_with_path(
                    getattr(r_state.opt, name))[0]):
            assert str(p.dtype).removeprefix("torch.") == r.dtype.name
            tol = mom_tol if mom_tol_of is None else mom_tol_of(
                "/".join(k.key for k in path), mom_tol)
            assert _norm_rel(p, r) <= tol, (name, path, _norm_rel(p, r))
    assert int(p_state.opt.count) == int(r_state.opt.count) == steps
    assert int(p_state.step) == int(r_state.step) == steps
    assert float(p_state.loss_scale.scale) == float(r_state.loss_scale.scale)
    assert int(p_state.loss_scale.good_steps) == \
        int(r_state.loss_scale.good_steps)


@pytest.mark.parametrize("fusion", ["off", "static"])
@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("amp", ["O0", "O1", "O2"])
def test_train_step_matches_reference(amp, mb, fusion):
    init_np, ref_steps = _reference(amp, mb)
    run = p_base.RunConfig(amp=amp, microbatches=mb, fusion=fusion)
    model = p_api.build(p_get_smoke("glm4-9b"))
    state = from_jax_numpy(init_np)
    assert isinstance(state, p_step.TrainState)
    step = p_step.make_train_step(model, run, lr=LR)
    for i, b in enumerate(_batches(STEPS)):
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i + 1 in (1, STEPS):
            r_state, r_metrics = ref_steps[i]
            _compare(state, metrics, r_state, r_metrics, amp, i + 1)


def test_overflow_skips_the_update_and_halves_the_scale():
    """O2 with a non-finite weight: both packages keep params and moments,
    keep the count, halve the scale and reset the good-step count."""
    init_np, _ = _reference("O2", 1)
    params = jax.tree.map(np.copy, init_np.params)
    params["ln_f"]["scale"][0] = np.inf
    init_np = init_np._replace(params=params)
    b = _batches(1)[0]
    run = r_base.RunConfig(amp="O2")
    model = r_api.build(r_get_smoke("glm4-9b"))
    r_state = jax.tree.map(jnp.asarray, init_np)
    r_state, r_metrics = jax.jit(r_step.make_train_step(model, run))(
        r_state, {k: jnp.asarray(v) for k, v in b.items()})

    p_state = from_jax_numpy(init_np)
    p_before = [t.clone() for t in tree_flatten(p_state.params)[0]]
    p_state, p_metrics = p_step.make_train_step(
        p_api.build(p_get_smoke("glm4-9b")), p_base.RunConfig(amp="O2"))(
        p_state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(p_metrics["grads_finite"]) == \
        float(r_metrics["grads_finite"]) == 0.0
    for before, after in zip(p_before, tree_flatten(p_state.params)[0]):
        assert torch.equal(before, after)
    assert all(float(t.abs().max()) == 0.0
               for t in tree_flatten(p_state.opt.mu)[0])
    assert int(p_state.opt.count) == int(r_state.opt.count) == 0
    assert float(p_state.loss_scale.scale) == \
        float(r_state.loss_scale.scale) == 2.0 ** 14
    assert int(p_state.loss_scale.good_steps) == \
        int(r_state.loss_scale.good_steps) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("fusion", ["off", "static"])
def test_adamw_update_matches_reference(fusion, inplace, dtype):
    """One update on a two-leaf tree with odd sizes (f32: exact to 1 ulp —
    same fp32 ops, XLA may fold a constant; bf16 storage: one bf16 ulp)."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 7), "b": (4097,)}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    p_np = {k: mk(s) for k, s in shapes.items()}
    g_np = {k: mk(s) for k, s in shapes.items()}
    m_np = {k: mk(s) * 0.1 for k, s in shapes.items()}
    v_np = {k: np.abs(mk(s)) * 0.01 for k, s in shapes.items()}
    jdt = jnp.dtype(dtype)
    r_state = r_optim.AdamWState(
        jax.tree.map(lambda x: jnp.asarray(x, jdt), m_np),
        jax.tree.map(lambda x: jnp.asarray(x, jdt), v_np),
        jnp.asarray(2, jnp.int32))
    r_p, r_s = r_optim.adamw_update(
        jax.tree.map(jnp.asarray, g_np), r_state,
        jax.tree.map(lambda x: jnp.asarray(x, jdt), p_np), run=None)

    tdt = getattr(torch, dtype)
    # copies: jnp.asarray may wrap a numpy array without copying it and
    # read it after returning (asynchronous dispatch), so an update in
    # place must not write into the arrays the reference was given
    conv = lambda t: {k: torch.from_numpy(v.copy()).to(tdt)
                      for k, v in t.items()}
    params, mu, nu = conv(p_np), conv(m_np), conv(v_np)
    grads = {k: torch.from_numpy(v) for k, v in g_np.items()}
    state = p_optim.AdamWState(mu, nu, torch.tensor(2, dtype=torch.int32))
    new_p, new_s = p_optim.adamw_update(
        grads, state, params, run=p_base.RunConfig(fusion=fusion),
        inplace=inplace)
    assert (new_p["a"] is params["a"]) == inplace
    assert int(new_s.count) == 3
    tol = 2.0 ** -23 if dtype == "float32" else 2.0 ** -8
    for name, got, want in (("p", new_p, r_p), ("m", new_s.mu, r_s.mu),
                            ("v", new_s.nu, r_s.nu)):
        for k in shapes:
            w = _f32(want[k])
            np.testing.assert_allclose(
                _f32(got[k]), w, rtol=0,
                atol=2 * tol * float(np.abs(w).max()), err_msg=name + k)


def test_loss_scale_matches_reference():
    from repro.distributed import amp as r_amp
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal((5, 3)).astype(np.float32) * 1e4}
    for good, finite in ((0, True), (1999, True), (7, False)):
        rs = r_amp.DynLossScale(jnp.float32(2.0 ** 15), jnp.int32(good))
        ps = p_amp.DynLossScale(torch.tensor(2.0 ** 15),
                                torch.tensor(good, dtype=torch.int32))
        gg = dict(g) if finite else {"w": np.full((5, 3), np.inf,
                                                  np.float32)}
        r_g, r_new, r_fin = r_amp.unscale_and_update(
            jax.tree.map(jnp.asarray, gg), rs)
        p_g, p_new, p_fin = p_amp.unscale_and_update(
            {k: torch.from_numpy(v) for k, v in gg.items()}, ps)
        assert bool(p_fin) == bool(r_fin) == finite
        assert float(p_new.scale) == float(r_new.scale)
        assert int(p_new.good_steps) == int(r_new.good_steps)
        np.testing.assert_array_equal(_f32(p_g["w"]), _f32(r_g["w"]))
        assert p_amp.scale_loss(torch.tensor(2.0), ps).item() == \
            float(r_amp.scale_loss(jnp.float32(2.0), rs))


def test_phases_on_meta_allocate_nothing():
    """make_phases runs on meta tensors (the analytical path): bwd returns
    a grad per param with the param's dtype, opt returns the same tensors
    it was given (in place) and a new count."""
    cfg = p_get_smoke("glm4-9b")
    model = p_api.build(cfg)
    run = p_base.RunConfig(amp="O1", fusion="static")
    state = p_step.init_state(model, run, None, "meta")
    batch = p_api.synthetic_batch(
        cfg, p_base.ShapeSpec("t", 32, 4, "train"), 4, None, "meta")
    ph = p_step.make_phases(model, run)
    assert ph["fwd"](state.params, batch).shape == ()
    grads = ph["bwd"](state.params, batch)
    for p, g in zip(tree_flatten(state.params)[0], tree_flatten(grads)[0]):
        assert g.device.type == "meta" and g.shape == p.shape
        assert g.dtype == p.dtype == torch.float32
    new_p, new_s = ph["opt"](state.params, grads, state.opt)
    assert new_p["ln_f"]["scale"] is state.params["ln_f"]["scale"]
    assert new_s.count.device.type == "meta"


def test_from_jax_numpy_carries_a_whole_train_state():
    init_np, _ = _reference("O2", 1)
    s = from_jax_numpy(init_np)
    assert isinstance(s.opt, p_optim.AdamWState)
    assert isinstance(s.loss_scale, p_amp.DynLossScale)
    assert s.opt.count.dtype == torch.int32 and s.opt.count.shape == ()
    assert s.loss_scale.scale.dtype == torch.float32
    assert float(s.loss_scale.scale) == 2.0 ** 15
    assert s.params["blocks"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert s.opt.mu["blocks"]["mlp"]["w_up"].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="named tuple"):
        from collections import namedtuple
        from_jax_numpy(namedtuple("Other", "x")(np.zeros(2)))
