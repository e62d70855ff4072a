"""The port's Adafactor against the reference's ``adafactor_init`` /
``adafactor_update`` on the same arrays (numpy, from a seed), and the
smoke train step under ``optimizer="adafactor"``.

Tolerances (fp32 moments, O0/O1): params within 1e-6 (lr 1e-3 times an
update of RMS ≤ 1 whose fp32 means are summed in another order); vr, vc
and v within 1e-5 of their norm.  bf16 moments (O2): one bf16 spacing of
the leaf's largest |value| (the same fp32 value rounded once).  The train
step: ``test_torch_train.py``'s loss and grad-norm rtol (1e-5 / 1e-2 at
O0 / O1), params atol 2e-5 at O0 and 2·lr a step at O1 (an update of
size up to lr that flips sign where a gradient is near zero), the
second-moment factors within 1e-5 / 5e-2 of their norm.
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
from repro_torch.models import api as p_api
from repro_torch.models.params import from_jax_numpy
from repro_torch.train import optim as p_optim
from repro_torch.train import step as p_step

from test_torch_train import _batches

LR = 1e-3
# rank-1, rank-2, a stacked rank-3 (L, D, F) and a stacked rank-4
# (L, D, H, hd) leaf: the last factors over (H, hd), not (D, H·hd)
SHAPES = {"norm": (24,), "unembed": (16, 40), "w_up": (3, 16, 24),
          "wq": (3, 16, 4, 8)}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _norm_rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("amp", ["O0", "O1", "O2"])
def test_init_shapes_and_dtypes_match_reference(amp):
    params = _tree(np.random.default_rng(0))
    r = r_optim.adafactor_init(jax.tree.map(jnp.asarray, params),
                               r_base.RunConfig(amp=amp))
    p = p_optim.adafactor_init({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               p_base.RunConfig(amp=amp))
    for name in ("vr", "vc", "v"):
        for k in SHAPES:
            rt, pt = getattr(r, name)[k], getattr(p, name)[k]
            assert tuple(pt.shape) == rt.shape, (name, k)
            assert str(pt.dtype).removeprefix("torch.") == rt.dtype.name
            assert not pt.any()
    assert p.vr["wq"].shape == (3, 16, 4) and p.vc["wq"].shape == (3, 16, 8)
    assert int(p.count) == int(r.count) == 0
    assert p.count.dtype == torch.int32


def _run_both(amp: str, steps: int, inplace: bool = False, grad_scale=None):
    """``steps`` updates of both packages from the same params and
    gradients → (reference (params, state), port (params, state))."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    if grad_scale is not None:
        for i, g in enumerate(grads):
            g.update(grad_scale(i, g))
    run_r, run_p = r_base.RunConfig(amp=amp), p_base.RunConfig(amp=amp)
    pdt = torch.float32 if amp != "O2" else torch.bfloat16
    rp = jax.tree.map(lambda x: jnp.asarray(x, run_r.param_dtype), params)
    rs = r_optim.adafactor_init(rp, run_r)
    # copies: jnp.asarray may wrap a numpy array without copying it and
    # read it after returning (asynchronous dispatch), so an update in
    # place must not write into the arrays the reference was given
    tp = {k: torch.from_numpy(v.copy()).to(pdt) for k, v in params.items()}
    ts = p_optim.adafactor_init(tp, run_p)
    for g in grads:
        rp, rs = r_optim.adafactor_update(jax.tree.map(jnp.asarray, g), rs,
                                          rp, lr=LR)
        tp, ts = p_optim.adafactor_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, lr=LR,
            inplace=inplace)
    return (rp, rs), (tp, ts)


def _hold(ref, port, amp: str):
    (rp, rs), (tp, ts) = ref, port
    for k in SHAPES:
        if amp == "O2":
            tol = 2.0 ** -7 * float(np.abs(_f32(rp[k])).max())
        else:
            tol = 1e-6
        np.testing.assert_allclose(_f32(tp[k]), _f32(rp[k]), rtol=0,
                                   atol=tol, err_msg=k)
        for name in ("vr", "vc", "v"):
            r, p = getattr(rs, name)[k], getattr(ts, name)[k]
            assert str(p.dtype).removeprefix("torch.") == r.dtype.name
            if amp == "O2":
                np.testing.assert_allclose(
                    _f32(p), _f32(r), rtol=0, err_msg=f"{name} {k}",
                    atol=2.0 ** -7 * float(np.abs(_f32(r)).max()))
            else:
                assert _norm_rel(p, r) <= 1e-5, (name, k)
    assert int(ts.count) == int(rs.count)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("amp", ["O0", "O2"])
def test_update_matches_reference(amp, steps):
    _hold(*_run_both(amp, steps), amp)


def _loud_layer(i, g):
    """Layer 0 of each stacked leaf takes 100x the gradient from the
    second step on.  Its second moment lags (b2 = 1 − count^−0.8 weighs
    the old one), so its update's RMS reaches about 1/sqrt(1 − b2) =
    1.32 at step 2, where a steady Gaussian layer's stays near 1."""
    scale = np.ones(3, np.float32)
    scale[0] = 1.0 if i == 0 else 100.0
    return {k: g[k] * scale.reshape((3,) + (1,) * (g[k].ndim - 1))
            for k in ("w_up", "wq")}


@pytest.mark.parametrize("steps", [1, 3])
def test_blocked_branch_clips_per_layer_slice(monkeypatch, steps):
    """A stacked leaf past ``_BLOCK_BYTES`` (lowered in both packages) is
    updated one layer slice at a time, so its update-clipping RMS is per
    layer, and the port's blocked update equals the reference's.  By
    step 3 the loud layer's RMS clips the whole unblocked leaf, and the
    blocked update moves the quiet layers further."""
    unblocked = _run_both("O0", steps, grad_scale=_loud_layer)[1]
    monkeypatch.setattr(r_optim, "_BLOCK_BYTES", 1024)
    monkeypatch.setattr(p_optim, "_BLOCK_BYTES", 1024)
    calls = []
    real = p_optim._factored
    monkeypatch.setattr(p_optim, "_factored", lambda g, *a, **k: (
        calls.append(tuple(g.shape)), real(g, *a, **k))[1])
    ref, port = _run_both("O0", steps, grad_scale=_loud_layer)
    _hold(ref, port, "O0")
    # the two stacked leaves (4,608 and 6,144 bytes) took the blocked
    # branch, one call a layer slice; the rank-2 leaf (2,560 bytes) is not
    # stacked (its dim 0 is its rows): one call
    assert calls == steps * ([(16, 40)] + [(16, 24)] * 3
                             + [(16, 4, 8)] * 3)
    if steps == 3:
        for k in ("w_up", "wq"):
            # a hundred times the parity tolerance
            moved = float((port[0][k] - unblocked[0][k])[1:].abs().max())
            assert moved > 1e-4, (k, moved)
    assert torch.equal(port[0]["unembed"], unblocked[0]["unembed"])
    _, inplace = _run_both("O0", steps, inplace=True,
                           grad_scale=_loud_layer)
    for a, b in zip(tree_flatten(inplace)[0], tree_flatten(port)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("amp", ["O0", "O2"])
def test_inplace_equals_out_of_place(amp):
    _, out = _run_both(amp, 3)
    _, ins = _run_both(amp, 3, inplace=True)
    for a, b in zip(tree_flatten(ins)[0], tree_flatten(out)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_inplace_writes_over_the_given_trees():
    params = {k: torch.from_numpy(v)
              for k, v in _tree(np.random.default_rng(2)).items()}
    state = p_optim.adafactor_init(params, p_base.RunConfig())
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new_p, new_s = p_optim.adafactor_update(grads, state, params,
                                            inplace=True)
    assert new_p is params and new_s.vr is state.vr and new_s.v is state.v
    assert new_s.count is not state.count and int(new_s.count) == 1
    assert float(state.vr["wq"].abs().max()) > 0


def test_update_refuses_a_tree_unlike_the_params():
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    state = p_optim.adafactor_init(params, p_base.RunConfig())
    with pytest.raises(ValueError, match="grads tree does not match"):
        p_optim.adafactor_update({"w": torch.zeros(4, 3)}, state, params)
    with pytest.raises(ValueError, match="vc tree does not match"):
        p_optim.adafactor_update(params, state._replace(vc=[]), params)


def test_optimizer_dispatch_follows_the_run():
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    for name, kind in (("adafactor", p_optim.AdafactorState),
                       ("adamw", p_optim.AdamWState)):
        run = p_base.RunConfig(optimizer=name)
        state = p_optim.optimizer_init(params, run)
        assert isinstance(state, kind)
        _, new = p_optim.optimizer_update(grads, state, params, run)
        assert isinstance(new, kind) and int(new.count) == 1


# --------------------------------------------------------------------------
# The smoke train step under Adafactor
# --------------------------------------------------------------------------

ARCH = "minitron-4b"
STEP_LR = 3e-4
_REF: dict = {}


def _reference_steps(amp: str):
    if amp not in _REF:
        run = r_base.RunConfig(amp=amp, optimizer="adafactor")
        model = r_api.build(r_get_smoke(ARCH))
        state = r_step.init_state(model, run, jax.random.PRNGKey(0))
        init_np = jax.tree.map(np.asarray, state)
        fn = jax.jit(r_step.make_train_step(model, run, lr=STEP_LR))
        out = []
        for b in _batches(3):
            state, metrics = fn(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            out.append(jax.tree.map(np.asarray, (state, metrics)))
        _REF[amp] = (init_np, out)
    return _REF[amp]


@pytest.mark.parametrize("fusion", ["off", "static"])
@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_train_step_under_adafactor_matches_reference(amp, fusion):
    init_np, ref_steps = _reference_steps(amp)
    state = from_jax_numpy(init_np)
    assert isinstance(state.opt, p_optim.AdafactorState)
    step = p_step.make_train_step(
        p_api.build(p_get_smoke(ARCH)),
        p_base.RunConfig(amp=amp, fusion=fusion, optimizer="adafactor"),
        lr=STEP_LR)
    rtol, mtol = (1e-5, 1e-5) if amp == "O0" else (1e-2, 5e-2)
    for i, b in enumerate(_batches(3)):
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i + 1 not in (1, 3):
            continue
        r_state, r_metrics = ref_steps[i]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[k]),
                                       float(r_metrics[k]), rtol=rtol)
        atol = 2e-5 if amp == "O0" else 2 * STEP_LR * (i + 1)
        for p, r in zip(tree_flatten(state.params)[0],
                        jax.tree.leaves(r_state.params)):
            np.testing.assert_allclose(_f32(p), _f32(r), atol=atol, rtol=0)
        for name in ("vr", "vc", "v"):
            for p, r in zip(tree_flatten(getattr(state.opt, name))[0],
                            jax.tree.leaves(getattr(r_state.opt, name))):
                assert tuple(p.shape) == r.shape
                assert _norm_rel(p, r) <= mtol, (name, _norm_rel(p, r))
        assert int(state.opt.count) == int(r_state.opt.count) == i + 1
