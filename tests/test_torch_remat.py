"""``remat`` in the port against ``remat="none"`` and against the reference
under the same mode.

* The loss and every gradient under ``"dots"`` and ``"full"`` equal the
  port's ``"none"`` exactly (the recompute runs the same ops on the same
  inputs), and the reference's under the same mode within
  ``test_torch_model.py``'s tolerances: loss rtol 1e-5 / 1e-2 at O0 /
  O1, each gradient within 1e-5 / 5e-2 of its norm (the mamba2 per-head
  leaves at O1: 0.15, ``test_torch_ssm.py``'s ``HEAD_LEAF_MOM_TOL``, for
  the reason given there).
* The walk's bwd matmul FLOPs per mode equal the reference's HLO count
  for the dense configs; for mamba2 they differ by the terms
  ``test_torch_ssm.py`` holds at ``"none"``, the same at every mode.
  What each mode adds is held exactly: ``"dots"`` the batched products
  of each block (QKᵀ and PV; the SSD scan's einsums), ``"full"`` each
  block's forward products but its last (whose output no backward
  reads; XLA drops it from the rematerialised program too).
* The ``"dots"`` policy keeps exactly the products against a weight.

Parameters are the reference's (PRNGKey 0), carried over by
``from_jax_numpy``; tokens are drawn with numpy.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro.configs import base as r_base
from repro.configs.registry import get_smoke as r_get_smoke
from repro.core import roofline as r_roofline
from repro.kernels.ssd_scan import ops as r_ssd_ops
from repro.models import api as r_api
from repro.models import params as r_params
from repro.models import ssm as r_ssm
from repro.session import Session as RSession
from repro.trace.cli import build_phase_args
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.core import roofline as p_roofline
from repro_torch.models import api as p_api
from repro_torch.models import layers as p_layers
from repro_torch.models import transformer as p_tr
from repro_torch.models.params import from_jax_numpy
from repro_torch.session.session import Session
from repro_torch.train.step import value_and_grad

MODES = ("dots", "full")
TOL = {"O0": (1e-5, 1e-5), "O1": (1e-2, 5e-2)}   # loss rtol, grad norm-rel
HEAD_LEAF_TOL = 0.15
HEAD_LEAVES = ("blocks/ssm/A_log", "blocks/ssm/D_skip", "blocks/ssm/dt_bias")
# (arch, port run keywords): the dense family's gated and ungated MLPs,
# the routed custom ops under fusion (fused norms and SwiGLU, flash),
# and the SSM at both scans
CASES = {
    "granite-8b": ("granite-8b", {}),
    "minitron-4b": ("minitron-4b", {}),
    "glm4-9b-static-flash": ("glm4-9b", dict(fusion="static",
                                             attn_impl="flash")),
    "mamba2-1.3b-xla": ("mamba2-1.3b", {}),
    "mamba2-1.3b-kernel": ("mamba2-1.3b", dict(fusion="static",
                                               ssd_impl="kernel")),
}


def _ref_ssd_plain(xh, a, B_, C_, chunk=None):
    return r_ssm.ssd_chunked(xh, a, B_, C_, chunk)[0]


@functools.lru_cache(maxsize=None)
def _setup(arch: str):
    r_cfg = r_get_smoke(arch)
    params = r_params.init(jax.random.PRNGKey(0), r_api.build(r_cfg).spec,
                           jnp.float32)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, r_cfg.vocab_size, (2, 32), dtype=np.int32)
             for k in ("tokens", "targets")}
    return jax.tree.map(np.asarray, params), batch


def _port_grads(arch, run, params_np, batch):
    model = p_api.build(p_get_smoke(arch))
    (loss, _), grads = value_and_grad(
        lambda p, b: model.loss_fn(p, b, run), from_jax_numpy(params_np),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), tree_flatten(grads)[0]


@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_equal_none_and_the_reference(monkeypatch, case,
                                                         mode, amp):
    arch, kw = CASES[case]
    params_np, batch = _setup(arch)
    loss0, grads0 = _port_grads(arch, p_base.RunConfig(amp=amp, **kw),
                                params_np, batch)
    loss, grads = _port_grads(arch, p_base.RunConfig(amp=amp, remat=mode,
                                                     **kw),
                              params_np, batch)
    assert loss == loss0
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))

    # the reference at fusion="off" and einsum attention (the same
    # function as its Pallas routes); its Pallas SSD route replaced by its
    # plain scan, as test_torch_ssm.py does
    monkeypatch.setattr(r_ssd_ops, "ssd_scan_model_layout", _ref_ssd_plain)
    r_run = r_base.RunConfig(amp=amp, remat=mode,
                             ssd_impl=kw.get("ssd_impl", "xla"))
    r_model = r_api.build(r_get_smoke(arch))
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_model.loss_fn(p, b, r_run)[0]))(
        jax.tree.map(jnp.asarray, params_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    rtol, gtol = TOL[amp]
    np.testing.assert_allclose(loss, float(r_loss), rtol=rtol)
    for (path, r), p in zip(jax.tree_util.tree_flatten_with_path(r_grads)[0],
                            grads):
        name = "/".join(k.key for k in path)
        r = np.asarray(r, dtype=np.float32)
        rel = float(np.linalg.norm(p.float().numpy() - r)
                    / max(np.linalg.norm(r), 1e-30))
        tol = HEAD_LEAF_TOL if amp == "O1" and name in HEAD_LEAVES else gtol
        assert rel <= tol, (name, rel)


def _matmul(analysis) -> float:
    return sum(k.total_flops for k in analysis.kernels
               if k.category == "matmul")


@pytest.fixture(scope="module")
def bwd_walks(tmp_path_factory):
    """{(arch, mode): (reference bwd, port bwd)} matmul FLOPs of the smoke
    bwd phase at seq 32, batch 4, O1 (the port at the xla and kernel SSD
    routes for mamba2)."""
    ref = RSession(machine="cpu-host",
                   workspace=str(tmp_path_factory.mktemp("ws")))
    port = Session(machine="cpu-host", device="cpu")
    out = {}
    for arch in ("granite-8b", "minitron-4b", "mamba2-1.3b"):
        for mode in ("none",) + MODES:
            fn, args = build_phase_args(
                r_api.build(r_get_smoke(arch)),
                r_base.RunConfig(amp="O1", remat=mode), seq=32, batch=4,
                concrete=False)["bwd"]
            r = _matmul(ref.profile(fn, args).analyses[fn.__name__])
            impls = ("xla", "kernel") if arch == "mamba2-1.3b" else ("xla",)
            out[arch, mode] = (r, {impl: _matmul(port.profile(
                arch, seq=32, batch=4, amp="O1", remat=mode, ssd_impl=impl,
                phases=("bwd",)).analyses["bwd"]) for impl in impls})
    return out


@pytest.mark.parametrize("arch", ["granite-8b", "minitron-4b"])
def test_dense_bwd_flops_per_mode_equal_the_reference(bwd_walks, arch):
    cfg = p_get_smoke(arch)
    B, S, L = 4, 32, cfg.n_layers
    fwd = p_tr.matmul_flops(cfg, B, S)
    att = p_tr.attention_flops(cfg, B, S)
    block = att["proj"] + att["qk_pv"] + p_tr.mlp_flops(cfg, B, S)
    down = 2 * B * S * cfg.d_ff * cfg.d_model
    want = {"none": 3 * fwd, "dots": 3 * fwd + L * att["qk_pv"],
            "full": 3 * fwd + L * (block - down)}
    for mode, total in want.items():
        r, p = bwd_walks[arch, mode]
        assert r == p["xla"] == total, mode


def test_ssm_bwd_flops_per_mode_against_the_reference(bwd_walks):
    """The xla route differs from the reference's HLO by the same
    constant at every mode (``test_torch_ssm.py``: XLA's recompute of
    C·state, the cotangent of the zero initial state and two
    reduce-as-dot gradients); each mode adds the same recompute in both:
    ``dots`` the scan's einsums (scores, the intra-chunk product and the
    inter-chunk C·state at the one chunk of S = 32), ``full`` those and
    in_proj (not out_proj, the layer's last product).  The kernel route's
    scan is one custom op: ``dots`` adds nothing, ``full`` in_proj."""
    cfg = p_get_smoke("mamba2-1.3b")
    B, S, L = 4, 32, cfg.n_layers
    H, P, N, D, di = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.d_model, cfg.d_inner)
    gap = L * (2 * 2 * B * S * H * P * N + 2 * 2 * B * S * H * P)
    scan = 2 * B * S * S * N + 2 * B * S * S * H * P + 2 * B * S * N * H * P
    in_proj = 2 * B * S * D * (2 * di + 2 * N + H)
    base_r, base_p = bwd_walks["mamba2-1.3b", "none"]
    assert base_r - base_p["xla"] == gap
    for mode, extra_xla, extra_kernel in (
            ("dots", L * scan, 0),
            ("full", L * (scan + in_proj), L * in_proj)):
        r, p = bwd_walks["mamba2-1.3b", mode]
        assert r - base_r == p["xla"] - base_p["xla"] == extra_xla, mode
        assert p["kernel"] - base_p["kernel"] == extra_kernel, mode
        assert r - p["xla"] == gap


@pytest.mark.parametrize("arch,saved,recomputed", [
    ("granite-8b", 7, 2),       # q, k, v, o, gate, up, down | QKᵀ, PV
    ("minitron-4b", 6, 2),      # q, k, v, o, up, down | QKᵀ, PV
    ("mamba2-1.3b", 2, 3),      # in_proj, out_proj | the scan's einsums
])
def test_dots_keeps_exactly_the_products_against_a_weight(
        monkeypatch, arch, saved, recomputed):
    """Per block, the forward's products the policy saves and the ones it
    leaves to the recompute."""
    seen = []

    def policy(ctx, op, *args, **kwargs):
        out = p_layers._dots_policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and op in p_layers._PRODUCTS:
            seen.append(out)
        return out

    monkeypatch.setattr(p_layers, "_DOTS_CONTEXTS", functools.partial(
        create_selective_checkpoint_contexts, policy))
    params_np, batch = _setup(arch)
    _port_grads(arch, p_base.RunConfig(amp="O1", remat="dots"), params_np,
                batch)
    L = p_get_smoke(arch).n_layers
    assert seen.count(CheckpointPolicy.MUST_SAVE) == L * saved
    assert seen.count(CheckpointPolicy.PREFER_RECOMPUTE) == L * recomputed


def test_wdot_takes_a_weight_only():
    x = torch.zeros(2, 3, 4)
    assert p_layers.wdot("bsd,df->bsf", x, torch.zeros(4, 5)).shape == \
        (2, 3, 5)
    with pytest.raises(ValueError, match="2-D or 3-D weight"):
        p_layers.wdot("bsd,d->bs", x, torch.zeros(4))


def test_model_flops_ratio_matches_the_reference_and_falls_with_remat(
        bwd_walks):
    """The port's ``model_flops_ratio`` is the reference's on the same
    counts, and the bwd phase's ratio falls none > dots > full by the
    recompute."""
    for total in (0.0, 3.0e9):
        ana = types.SimpleNamespace(total_flops=total)
        for n in (1, 4):
            assert p_roofline.model_flops_ratio(2.0e9, ana, n) == \
                r_roofline.model_flops_ratio(2.0e9, ana, n)
    cfg = p_get_smoke("granite-8b")
    useful = 3 * p_tr.matmul_flops(cfg, 4, 32)
    ratios = [p_roofline.model_flops_ratio(
        useful, types.SimpleNamespace(
            total_flops=bwd_walks["granite-8b", m][1]["xla"]), 1)
        for m in ("none", "dots", "full")]
    assert ratios[0] == 1.0 > ratios[1] > ratios[2] > 0.0


def test_run_config_accepts_the_reference_modes():
    for mode in ("none",) + MODES:
        assert p_base.RunConfig(remat=mode).remat == \
            r_base.RunConfig(remat=mode).remat == mode
    with pytest.raises(ValueError, match="unknown remat"):
        p_base.RunConfig(remat="some")
    assert dataclasses.replace(p_base.RunConfig(), remat="full").remat == \
        "full"
