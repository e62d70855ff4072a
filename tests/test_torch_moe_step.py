"""The MoE family's train step and op walk against the reference:
granite-moe-1b-a400m's AdamW steps, its O1 gradients against its fp32
ones, the phases' matmul FLOPs against the reference's HLO walk and the
analytic count (per remat mode), and the full-width walks on meta tensors
(granite-moe and kimi-k2).  Tolerances and the reasons for them:
``test_torch_moe.py``'s docstring.
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
from repro.session import Session as RSession
from repro.trace.cli import build_phase_args
from repro.train import step as r_step
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_config as p_get_config
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.models import api as p_api
from repro_torch.models import moe as p_moe
from repro_torch.models import transformer as p_tr
from repro_torch.models.params import from_jax_numpy
from repro_torch.session.session import Session
from repro_torch.train import step as p_step

from test_torch_moe import (ARCHS, MOE_LEAVES, O1_MOE_MOM_TOL, TOL, _params,
                            _tokens)
from test_torch_train import LR, _compare


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
            state, metrics = fn(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            out.append(jax.tree.map(np.asarray, (state, metrics)))
        _REF[key] = (init_np, out)
    return _REF[key]


@pytest.mark.parametrize("fusion", ["off", "static"])
@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_train_steps_match_reference(amp, fusion):
    """Three AdamW steps of granite-moe (batch 4, seq 32): loss, its aux,
    grad norm, params and both moments after steps 1 and 3."""
    arch = "granite-moe-1b-a400m"
    batches = [_tokens(20 + i, (4, 32)) for i in range(3)]
    init_np, ref_steps = _reference_steps(arch, amp, batches)
    model = p_api.build(p_get_smoke(arch))
    state = from_jax_numpy(init_np)
    step = p_step.make_train_step(model, p_base.RunConfig(
        amp=amp, fusion=fusion), lr=LR)
    for i, b in enumerate(batches):
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i + 1 in (1, 3):
            r_state, r_met = ref_steps[i]
            _compare(state, metrics, r_state, r_met, amp, i + 1,
                     mom_tol_of=lambda path, tol: O1_MOE_MOM_TOL if (
                         amp == "O1" and path.startswith(MOE_LEAVES))
                     else tol)
            np.testing.assert_allclose(float(metrics["aux"]),
                                       float(r_met["aux"]),
                                       rtol=TOL[amp][1])


def test_o1_gradients_stay_near_the_o0_ones():
    """Why the O1 moments of the MoE leaves take :data:`O1_MOE_MOM_TOL`:
    each package's O1 gradients lie within it of its own O0 (fp32)
    gradients on every leaf, the port's no farther than the reference's
    by more than 1e-2, and the two O1 gradients within it of each
    other."""
    from repro_torch.train.step import value_and_grad
    arch = "granite-moe-1b-a400m"
    params = _params(r_get_smoke(arch))
    b = _tokens(20, (4, 32))

    def port(amp):
        model, run = p_api.build(p_get_smoke(arch)), p_base.RunConfig(amp=amp)
        _, g = value_and_grad(lambda p, bb: model.loss_fn(p, bb, run),
                              from_jax_numpy(params),
                              {k: torch.from_numpy(v) for k, v in b.items()})
        return [t.float().numpy() for t in tree_flatten(g)[0]]

    def ref(amp):
        model, run = r_api.build(r_get_smoke(arch)), r_base.RunConfig(amp=amp)
        g = jax.jit(jax.grad(lambda p, bb: model.loss_fn(p, bb, run)[0]))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in b.items()})
        return [np.asarray(t, np.float32) for t in jax.tree.leaves(g)]

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for p0, p1, r0, r1 in zip(port("O0"), port("O1"), ref("O0"), ref("O1")):
        assert rel(p0, r0) < 1e-5
        assert rel(p1, p0) <= O1_MOE_MOM_TOL
        assert rel(r1, r0) <= O1_MOE_MOM_TOL
        assert rel(p1, p0) <= rel(r1, r0) + 1e-2
        assert rel(p1, r1) <= O1_MOE_MOM_TOL


def _matmul(analysis) -> float:
    return sum(k.total_flops for k in analysis.kernels
               if k.category == "matmul")


@pytest.fixture(scope="module")
def phase_walks(tmp_path_factory):
    """{arch: (reference, port)} matmul FLOPs per phase of the smoke step
    (seq 32, batch 4, O1; the reference's for granite-moe only: kimi's
    HLO walk adds nothing the count does not hold), and granite-moe's bwd
    under each remat mode."""
    ref = RSession(machine="cpu-host",
                   workspace=str(tmp_path_factory.mktemp("ws")))
    port = Session(machine="cpu-host", device="cpu")
    out = {}
    for arch in ARCHS:
        p = port.profile(arch, seq=32, batch=4, amp="O1")
        r = (ref.profile(arch, seq=32, batch=4, amp="O1").analyses
             if arch == "granite-moe-1b-a400m" else p.analyses)
        out[arch] = ({ph: _matmul(a) for ph, a in r.items()},
                     {ph: _matmul(a) for ph, a in p.analyses.items()})
    arch = "granite-moe-1b-a400m"
    for mode in ("none", "dots", "full"):
        fn, args = build_phase_args(
            r_api.build(r_get_smoke(arch)),
            r_base.RunConfig(amp="O1", remat=mode), seq=32, batch=4,
            concrete=False)["bwd"]
        out[arch, mode] = (
            _matmul(ref.profile(fn, args).analyses[fn.__name__]),
            _matmul(port.profile(arch, seq=32, batch=4, amp="O1",
                                 remat=mode, phases=("bwd",))
                    .analyses["bwd"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_phase_matmul_flops_match_reference_and_the_count(phase_walks, arch):
    """fwd, bwd, opt matmul FLOPs equal the reference's HLO walk; the fwd
    equals ``matmul_flops`` and the bwd three times it."""
    r, p = phase_walks[arch]
    want = p_tr.matmul_flops(p_get_smoke(arch), 4, 32)
    assert p == r == {"fwd": want, "bwd": 3 * want, "opt": 0}


def test_bwd_flops_per_remat_mode_equal_the_reference(phase_walks):
    """granite-moe's bwd under each remat mode equals the reference's.
    ``dots`` keeps the products against a weight (attention projections,
    the router) and recomputes QKᵀ, PV and the three expert products
    (``e`` a batch dim); ``full`` recomputes each block's forward, whose
    last product (w_down's) the gate's gradient reads through the
    combine."""
    cfg = p_get_smoke("granite-moe-1b-a400m")
    B, S, L = 4, 32, cfg.n_layers
    fwd = p_tr.matmul_flops(cfg, B, S)
    att = p_tr.attention_flops(cfg, B, S)
    C = p_moe._capacity(S, cfg)
    experts = 3 * 2 * B * cfg.n_experts * C * cfg.d_model * cfg.d_ff
    router = 2 * B * S * cfg.d_model * cfg.n_experts
    want = {"none": 3 * fwd,
            "dots": 3 * fwd + L * (att["qk_pv"] + experts),
            "full": 3 * fwd + L * (att["proj"] + att["qk_pv"] + router
                                   + experts)}
    for mode, total in want.items():
        r, p = phase_walks["granite-moe-1b-a400m", mode]
        assert r == p == total, mode


@pytest.mark.parametrize("arch,seq,batch", [
    ("granite-moe-1b-a400m", 2048, 2), ("kimi-k2-1t-a32b", 2048, 1)])
def test_full_width_walk_counts_exactly_on_meta(arch, seq, batch):
    """The full-width, full-depth fwd walk on meta tensors (kimi's fp32
    weights are about 4 TB): matmul FLOPs equal the count, the experts at
    E·C slots a group (granite-moe C = 640 at 2048 tokens)."""
    cfg = p_get_config(arch)
    prof = Session(machine="h100-sxm", device="cpu").profile(
        arch, smoke=False, seq=seq, batch=batch, phases=("fwd",))
    assert _matmul(prof.analyses["fwd"]) == p_tr.matmul_flops(cfg, batch,
                                                              seq)
    C = p_moe._capacity(seq, cfg)
    experts = [k for k in prof.analyses["fwd"].kernels
               if k.category == "matmul" and k.total_flops
               == cfg.n_layers * 2 * batch * cfg.n_experts * C
               * cfg.d_model * cfg.d_ff]
    assert experts, "no expert product at E·C slots"
