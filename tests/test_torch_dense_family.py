"""The rest of the dense family — granite-8b, minitron-4b (ungated relu²,
a 256,000-column vocabulary) and mistral-large-123b — and a ``geglu``
variant of glm4-9b (the one act that reaches ``fused_swiglu``'s gelu
route; no config uses it), against the reference on the same parameters.

Parameters and train states are made by the reference (PRNGKey 0) and
carried over by ``from_jax_numpy``; tokens are drawn with numpy.  The
reference runs at ``fusion="off"`` (its fused Pallas kernels need a TPU
compiler option this jax lacks, and compute the same function); the port
at ``off`` and ``static``, where the routed ops run their plain versions
on the host.  Tolerances:

* logits atol 1e-4 at O0 and 6e-2 at O1, loss rtol 1e-5 / 1e-2:
  ``test_torch_model.py``'s, but for the O1 logits: bf16 rounds at other
  places in the two frameworks, and the geglu variant reads 0.0508 at
  one of 32,768 logits of |value| near 2 (seven bf16 spacings; the
  other configs 0.006–0.04), over glm4's 5e-2;
* the train step: ``test_torch_train.py``'s, and at O0 at most 1e-4 of
  a leaf's params may pass its 2e-5, each within 2·lr a step
  (:data:`KINK_SHARE`): AdamW's first steps move a weight by about
  lr·g/(|g| + 1e-8), so where the gradient is near 1e-8 or below a
  difference of summation order moves it by up to lr (mistral: 2 of
  81,920 ``w_gate`` elements, gradient −2.0e-10, 9.8e-5 apart; geglu: 1
  of 28,672 ``w_down``, gradient −6.4e-9, 1.4e-4).  The gradients of the
  next steps inherit those weights: at O0 the moments after step 3 are
  held within 5e-5 of their norm (:data:`O0_MOM_TOL`; measured worst
  2.2e-5, mistral ``wk``'s first moment), where step 1's gradients agree
  within 1.1e-6 of their norm on every leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import get_smoke as r_get_smoke
from repro.configs import base as r_base
from repro.models import api as r_api
from repro.models import params as r_params
from repro.session import Session as RSession
from repro.train import step as r_step
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_config as p_get_config
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.kernels.fused import swiglu as p_swiglu
from repro_torch.models import api as p_api
from repro_torch.models import params as p_params
from repro_torch.models import transformer as p_tr
from repro_torch.models.params import from_jax_numpy
from repro_torch.session.session import Session
from repro_torch.train import step as p_step

from test_torch_train import LR, _batches, _compare

ARCHS = ("granite-8b", "minitron-4b", "mistral-large-123b")
GEGLU = "glm4-9b-geglu"
TOL = {"O0": (1e-4, 1e-5), "O1": (6e-2, 1e-2)}
KINK_SHARE = {"O0": 1e-4, "O1": 0.0}
O0_MOM_TOL = 5e-5


def _configs(name: str):
    """(reference, port) smoke configs; the geglu variant is glm4-9b's
    smoke with ``act="geglu"`` in both packages."""
    if name == GEGLU:
        return tuple(dataclasses.replace(get("glm4-9b"), name=GEGLU,
                                         act="geglu")
                     for get in (r_get_smoke, p_get_smoke))
    return r_get_smoke(name), p_get_smoke(name)


@pytest.fixture(scope="module", params=ARCHS + (GEGLU,))
def smoke(request):
    r_cfg, p_cfg = _configs(request.param)
    params = r_params.init(jax.random.PRNGKey(0), r_api.build(r_cfg).spec,
                           jnp.float32)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, r_cfg.vocab_size, (2, 32), dtype=np.int32)
    targets = rng.integers(0, r_cfg.vocab_size, (2, 32), dtype=np.int32)
    return (r_cfg, p_cfg, jax.tree.map(np.asarray, params), tokens,
            targets)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_reference(arch):
    for r_cfg, p_cfg in ((r_get_config(arch), p_get_config(arch)),
                         (r_get_smoke(arch), p_get_smoke(arch))):
        assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
        assert p_cfg.param_count() == r_cfg.param_count()
        # the dense counts equal their spec trees' leaves exactly
        assert p_cfg.param_count() == p_params.count(
            p_api.build(p_cfg).spec)
    assert p_get_config("mistral-large-123b").param_count() \
        == 122_610_069_504
    assert p_get_config("minitron-4b").vocab_size == 256_000


def test_spec_trees_match_reference(smoke):
    r_cfg, p_cfg, params_np, _, _ = smoke
    r_leaves = jax.tree_util.tree_flatten_with_path(params_np)[0]
    p_leaves = p_params.leaves(p_api.build(p_cfg).spec)
    assert [("/".join(k.key for k in path), tuple(a.shape))
            for path, a in r_leaves] == [(path, spec.shape)
                                         for path, spec in p_leaves]
    mlp = p_api.build(p_cfg).spec["blocks"]["mlp"]
    gated = p_cfg.act in ("swiglu", "geglu")
    assert ("w_gate" in mlp) == gated and {"w_up", "w_down"} <= set(mlp)


@pytest.mark.parametrize("fusion", ["off", "static"])
@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_logits_and_loss_match_reference(smoke, amp, fusion):
    r_cfg, p_cfg, params_np, tokens, targets = smoke
    r_run = r_base.RunConfig(amp=amp)
    p_run = p_base.RunConfig(amp=amp, fusion=fusion)
    r_model = r_api.build(r_cfg)
    params = jax.tree.map(jnp.asarray, params_np)
    r_logits = jax.jit(lambda p, t: r_model.forward_fn(
        p, {"tokens": t}, r_run))(params, jnp.asarray(tokens))
    r_loss = jax.jit(lambda p, b: r_model.loss_fn(p, b, r_run)[0])(
        params, {"tokens": jnp.asarray(tokens),
                 "targets": jnp.asarray(targets)})
    p_model = p_api.build(p_cfg)
    tp = from_jax_numpy(params_np)
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)}
    with torch.no_grad():
        p_logits = p_model.forward_fn(tp, batch, p_run)
        p_loss = p_model.loss_fn(tp, batch, p_run)[0]
    atol, rtol = TOL[amp]
    assert p_logits.shape == (2, 32, p_cfg.vocab_padded)
    np.testing.assert_allclose(p_logits.float().numpy(),
                               np.asarray(r_logits, dtype=np.float32),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=rtol)


_REF: dict = {}


def _reference_steps(name: str, amp: str):
    """(initial state as numpy, [(state, metrics) after each of 3
    steps]) of the reference's train step, once per (config, amp)."""
    key = (name, amp)
    if key not in _REF:
        run = r_base.RunConfig(amp=amp)
        model = r_api.build(_configs(name)[0])
        state = r_step.init_state(model, run, jax.random.PRNGKey(0))
        init_np = jax.tree.map(np.asarray, state)
        fn = jax.jit(r_step.make_train_step(model, run, lr=LR))
        out = []
        for b in _batches(3):
            state, metrics = fn(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            out.append(jax.tree.map(np.asarray, (state, metrics)))
        _REF[key] = (init_np, out)
    return _REF[key]


@pytest.mark.parametrize("fusion", ["off", "static"])
@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("name", ARCHS + (GEGLU,))
def test_train_step_matches_reference(name, amp, fusion):
    """After steps 1 and 3: loss, grad norm, params and both AdamW
    moments (``test_torch_train.py``'s tolerances)."""
    init_np, ref_steps = _reference_steps(name, amp)
    model = p_api.build(_configs(name)[1])
    state = from_jax_numpy(init_np)
    step = p_step.make_train_step(model, p_base.RunConfig(
        amp=amp, fusion=fusion), lr=LR)
    for i, b in enumerate(_batches(3)):
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i + 1 in (1, 3):
            _compare(state, metrics, *ref_steps[i], amp, i + 1,
                     kink_share=KINK_SHARE[amp],
                     mom_tol_of=(lambda path, tol: O0_MOM_TOL)
                     if amp == "O0" else None)


def _matmul(analysis) -> float:
    return sum(k.total_flops for k in analysis.kernels
               if k.category == "matmul")


@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_phase_matmul_flops_match_reference_and_the_count(tmp_path, arch,
                                                          amp):
    """fwd, bwd and opt matmul FLOPs of the smoke phases (seq 32, batch 4)
    equal the reference's HLO walk exactly; the fwd equals
    ``transformer.matmul_flops`` (two MLP products for minitron's relu²,
    three for the gated acts) and the bwd three times it."""
    cfg = p_get_smoke(arch)
    ref = RSession(machine="cpu-host", workspace=str(tmp_path)).profile(
        arch, seq=32, batch=4, amp=amp)
    port = Session(machine="cpu-host", device="cpu").profile(
        arch, seq=32, batch=4, amp=amp)
    got = {ph: _matmul(a) for ph, a in port.analyses.items()}
    assert got == {ph: _matmul(a) for ph, a in ref.analyses.items()}
    want = p_tr.matmul_flops(cfg, 4, 32)
    assert got == {"fwd": want, "bwd": 3 * want, "opt": 0}
    n_mlp = 2 if cfg.act == "relu2" else 3
    assert p_tr.mlp_flops(cfg, 4, 32) == n_mlp * 2 * 4 * 32 * cfg.d_model \
        * cfg.d_ff


@pytest.mark.parametrize("arch,seq,batch", [("minitron-4b", 2048, 2),
                                            ("mistral-large-123b", 2048, 1)])
def test_full_width_walk_counts_exactly_on_meta(arch, seq, batch):
    """The full-width, full-depth fwd walk on meta tensors (nothing is
    allocated: mistral-large's bf16 weights alone are 245 GB): matmul
    FLOPs equal the count, with minitron's 256,000-column unembedding."""
    cfg = p_get_config(arch)
    prof = Session(machine="h100-sxm", device="cpu").profile(
        arch, smoke=False, seq=seq, batch=batch, phases=("fwd",))
    assert _matmul(prof.analyses["fwd"]) == p_tr.matmul_flops(cfg, batch,
                                                              seq)
    unembed = [k for k in prof.analyses["fwd"].kernels
               if k.category == "matmul"
               and k.total_flops == 2 * batch * seq * cfg.d_model
               * cfg.vocab_padded]
    assert unembed and cfg.vocab_padded == (256_000 if arch ==
                                            "minitron-4b" else 32_768)


def test_geglu_static_reaches_the_gelu_route(monkeypatch):
    """Under ``static`` the geglu MLP calls ``fused_swiglu`` with
    ``act="gelu"`` (its plain version on the host) once per layer and
    pass; swiglu calls it with ``"silu"``; the ungated acts never."""
    seen = []
    real = p_swiglu.fused_swiglu

    def spy(gate, up, *, act="silu", **kw):
        seen.append(act)
        return real(gate, up, act=act, **kw)

    monkeypatch.setattr(p_swiglu, "fused_swiglu", spy)
    tokens = torch.zeros((2, 16), dtype=torch.int64)
    for name, want in ((GEGLU, "gelu"), ("granite-8b", "silu"),
                       ("minitron-4b", None)):
        cfg = _configs(name)[1]
        model = p_api.build(cfg)
        params = p_params.init(model.spec, torch.Generator().manual_seed(0))
        seen.clear()
        with torch.no_grad():
            model.forward_fn(params, {"tokens": tokens},
                             p_base.RunConfig(amp="O1", fusion="static"))
        assert seen == ([want] * cfg.n_layers if want else []), name


def test_ungated_acts_are_the_reference_functions():
    """relu² and the tanh gelu on the same inputs as the reference's
    ``jnp.square(jax.nn.relu(h))`` and ``jax.nn.gelu(h)`` (fp32: 2 ulps)."""
    h = np.random.default_rng(1).standard_normal((64, 96)).astype(np.float32)
    th = torch.from_numpy(h)
    for got, want in (
            (torch.square(torch.relu(th)), jnp.square(jax.nn.relu(h))),
            (p_swiglu.gelu_tanh(th), jax.nn.gelu(h))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2 * 2.0 ** -23 * float(
                                       np.abs(np.asarray(want)).max()))
