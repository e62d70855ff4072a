"""The port's hybrid (zamba2-1.2b: Mamba-2 layers and one shared
attention+MLP block with per-site norms) against the reference's, on the
same parameters: the spec tree, the parameter count, the site schedule,
logits, loss, the train step and the matmul FLOPs.

Parameters and train states are made by the reference (PRNGKey 0) and
carried over by ``from_jax_numpy``; tokens are drawn with numpy.  The
reference runs at ``fusion="off"`` and einsum attention (its Pallas
kernels need a TPU compiler option this jax lacks; the einsum route
computes the same function as its flash route), and at ``ssd_impl``
``"xla"``, or ``"kernel"`` with its Pallas scan replaced by its plain
``ssd_chunked`` on the same fp32 inputs, as ``test_torch_ssm.py`` does.
The port runs its own routes, the routed ops' plain versions on the
host.  Tolerances are ``test_torch_ssm.py``'s: logits atol 1e-4 / 5e-2,
loss rtol 1e-5 / 1e-2 at O0 / O1, the train step as
``test_torch_train.py`` holds it, with the AdamW moments of the per-head
SSM leaves at O1 held to 0.15 of their norm (``HEAD_LEAF_MOM_TOL``, for
the reason given there).
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
from repro.kernels.ssd_scan import ops as r_ssd_ops
from repro.models import api as r_api
from repro.models import hybrid as r_hybrid
from repro.models import params as r_params
from repro.models import ssm as r_ssm
from repro.train import step as r_step
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_config as p_get_config
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.kernels.flash_attention import kernel as p_flash_kernel
from repro_torch.kernels.ssd_scan import kernel as p_ssd_kernel
from repro_torch.models import api as p_api
from repro_torch.models import hybrid as p_hybrid
from repro_torch.models import params as p_params
from repro_torch.models import ssm as p_ssm
from repro_torch.models import transformer as p_tr
from repro_torch.models.params import from_jax_numpy
from repro_torch.session.session import Session
from repro_torch.train import step as p_step

from test_torch_ssm import HEAD_LEAF_MOM_TOL
from test_torch_train import LR, _batches, _compare

ARCH = "zamba2-1.2b"
TOL = {"O0": (1e-4, 1e-5), "O1": (5e-2, 1e-2)}
HEAD_LEAVES = ("ssm_blocks/ssm/A_log", "ssm_blocks/ssm/D_skip",
               "ssm_blocks/ssm/dt_bias")
# (ssd_impl, attn_impl, fusion) of the port's runs
ROUTES = [("xla", "einsum", "off"), ("kernel", "einsum", "static"),
          ("xla", "flash", "static"), ("kernel", "flash", "off")]


def _ref_ssd_plain(xh, a, B_, C_, chunk=None):
    return r_ssm.ssd_chunked(xh, a, B_, C_, chunk)[0]


@pytest.fixture
def ref_kernel_is_plain(monkeypatch):
    monkeypatch.setattr(r_ssd_ops, "ssd_scan_model_layout", _ref_ssd_plain)


@pytest.fixture(scope="module")
def smoke():
    r_cfg = r_get_smoke(ARCH)
    params = r_params.init(jax.random.PRNGKey(0), r_api.build(r_cfg).spec,
                           jnp.float32)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, r_cfg.vocab_size, (2, 32), dtype=np.int32)
    targets = rng.integers(0, r_cfg.vocab_size, (2, 32), dtype=np.int32)
    return jax.tree.map(np.asarray, params), tokens, targets


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_spec_tree_and_param_count_match_reference(size):
    """The spec trees hold the same names and shapes; ``param_count``
    mirrors the reference's, which falls short of the spec leaves by
    ``dt_bias`` and ``conv_b`` and all but one pair of site norms."""
    get_r, get_p = ((r_get_smoke, p_get_smoke) if size == "smoke"
                    else (r_get_config, p_get_config))
    r_cfg, p_cfg = get_r(ARCH), get_p(ARCH)
    assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
    r_leaves = jax.tree_util.tree_flatten_with_path(
        r_hybrid.hybrid_spec(r_cfg),
        is_leaf=lambda x: isinstance(x, r_params.P))[0]
    p_leaves = p_params.leaves(p_hybrid.hybrid_spec(p_cfg))
    assert [("/".join(k.key for k in path), tuple(s.shape))
            for path, s in r_leaves] == [(path, s.shape)
                                         for path, s in p_leaves]
    want = {"smoke": (177_664, 178_464),
            "full": (1_087_997_696, 1_088_181_120)}[size]
    assert (p_cfg.param_count(), p_params.count(
        p_api.build(p_cfg).spec)) == (r_cfg.param_count(), want[1])
    assert p_cfg.param_count() == want[0]
    assert p_hybrid.n_shared_sites(p_cfg) == (2 if size == "smoke" else 6)


@pytest.mark.parametrize("layers,group", [(4, 2), (5, 2), (6, 3), (38, 6)])
def test_site_schedule_matches_reference(monkeypatch, layers, group):
    """The order of Mamba-2 segments and shared-block sites, counted in
    both packages' forwards (the layers and sites record themselves and
    pass the hidden state through)."""
    r_cfg = dataclasses.replace(r_get_smoke(ARCH), n_layers=layers,
                                hybrid_group=group)
    p_cfg = dataclasses.replace(p_get_smoke(ARCH), n_layers=layers,
                                hybrid_group=group)
    r_events, p_events = [], []

    def r_scan(f, init, xs):
        r_events.append(("ssm", jax.tree.leaves(xs)[0].shape[0]))
        return init, None

    def r_site(params, x, site, *a, **k):
        r_events.append(("site", site))
        return x, None

    monkeypatch.setattr(jax.lax, "scan", r_scan)
    monkeypatch.setattr(r_hybrid, "_shared_block", r_site)
    params = r_params.init(jax.random.PRNGKey(0),
                           r_hybrid.hybrid_spec(r_cfg), jnp.float32)
    r_hybrid.forward(params, jnp.zeros((1, 4), jnp.int32), r_cfg,
                     r_base.RunConfig(amp="O0"))
    monkeypatch.undo()

    def p_layer(lp, x, *a):
        if p_events and p_events[-1][0] == "ssm":
            p_events[-1] = ("ssm", p_events[-1][1] + 1)
        else:
            p_events.append(("ssm", 1))
        return x

    def p_site(params, ln, ln2, x, *a):
        # each site's norm is a view of the stacked site_ln: its index
        p_events.append(("site", sites.index(ln["scale"].data_ptr())))
        return x

    monkeypatch.setattr(p_ssm, "layer_apply", p_layer)
    monkeypatch.setattr(p_hybrid, "_shared_block", p_site)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    sites = [t.data_ptr() for t in torch.unbind(tp["site_ln"]["scale"])]
    p_hybrid.forward(tp, torch.zeros((1, 4), dtype=torch.int64), p_cfg,
                     p_base.RunConfig(amp="O0"))
    assert p_events == r_events
    assert [(k, b - a if k == "ssm" else a)
            for k, a, b in p_hybrid.schedule(p_cfg)] == r_events
    n_sites = sum(k == "site" for k, _ in r_events)
    assert n_sites == p_hybrid.n_shared_sites(p_cfg) == layers // group
    if (layers, group) == (38, 6):
        assert r_events[-2:] == [("site", 5), ("ssm", 2)]
    if (layers, group) == (4, 2):
        assert r_events[-1] == ("site", 1)


@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("impl,attn,fusion", ROUTES)
def test_logits_and_loss_match_reference(smoke, ref_kernel_is_plain, impl,
                                         attn, fusion, amp):
    params_np, tokens, targets = smoke
    r_cfg, p_cfg = r_get_smoke(ARCH), p_get_smoke(ARCH)
    r_run = r_base.RunConfig(amp=amp, ssd_impl=impl)
    r_model = r_api.build(r_cfg)
    params = jax.tree.map(jnp.asarray, params_np)
    r_logits = jax.jit(lambda p, t: r_model.forward_fn(
        p, {"tokens": t}, r_run))(params, jnp.asarray(tokens))
    r_loss = jax.jit(lambda p, b: r_model.loss_fn(p, b, r_run)[0])(
        params, {"tokens": jnp.asarray(tokens),
                 "targets": jnp.asarray(targets)})
    p_run = p_base.RunConfig(amp=amp, ssd_impl=impl, attn_impl=attn,
                             fusion=fusion)
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


def _reference_steps(amp: str, impl: str):
    key = (amp, impl)
    if key not in _REF:
        run = r_base.RunConfig(amp=amp, ssd_impl=impl)
        model = r_api.build(r_get_smoke(ARCH))
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


def _mom_tol_of(path: str, tol: float) -> float:
    return HEAD_LEAF_MOM_TOL if path in HEAD_LEAVES else tol


@pytest.mark.parametrize("impl,attn,fusion", [("xla", "einsum", "off"),
                                              ("kernel", "flash", "static")])
@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_train_step_matches_reference(ref_kernel_is_plain, amp, impl, attn,
                                      fusion):
    init_np, ref_steps = _reference_steps(amp, impl)
    run = p_base.RunConfig(amp=amp, ssd_impl=impl, attn_impl=attn,
                           fusion=fusion)
    state = from_jax_numpy(init_np)
    step = p_step.make_train_step(p_api.build(p_get_smoke(ARCH)), run,
                                  lr=LR)
    for i, b in enumerate(_batches(3)):
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i + 1 in (1, 3):
            _compare(state, metrics, *ref_steps[i], amp, i + 1,
                     mom_tol_of=_mom_tol_of if amp == "O1" else None)


def _matmul(analysis) -> float:
    return sum(k.total_flops for k in analysis.kernels
               if k.category == "matmul")


def _custom(analysis, op: str) -> tuple[int, float]:
    recs = [k for k in analysis.kernels if k.opcode == op]
    return (sum(k.exec_count for k in recs),
            sum(k.total_flops for k in recs))


@pytest.mark.parametrize("size,seq,batch", [("smoke", 32, 4),
                                            ("full", 2048, 2)])
def test_matmul_flops_against_the_walk(size, seq, batch):
    """The fwd walk (meta tensors: nothing allocated at full width) at
    ``ssd_impl="kernel"``: matmul FLOPs equal ``hybrid.matmul_flops``
    with einsum attention, and that less the sites' QKᵀ and PV with
    flash; the ssd_scan records carry n_layers × the kernel's FLOPs and
    the flash records one a site.  The bwd at ``remat="full"`` equals
    the bwd at ``"none"``: the reference's hybrid ignores remat, and so
    does the port."""
    cfg = p_get_smoke(ARCH) if size == "smoke" else p_get_config(ARCH)
    s = Session(machine="h100-sxm", device="cpu")
    kw = dict(smoke=size == "smoke", seq=seq, batch=batch, amp="O1",
              ssd_impl="kernel", fusion="static")
    want = p_hybrid.matmul_flops(cfg, batch, seq)
    n_sites = p_hybrid.n_shared_sites(cfg)
    qk_pv = p_tr.attention_flops(cfg, batch, seq)["qk_pv"]
    q = min(cfg.ssm_chunk, seq)
    ssd = p_ssd_kernel.flops(batch, cfg.ssm_heads, seq, cfg.ssm_head_dim,
                             cfg.ssm_state, q)
    for attn in ("einsum", "flash"):
        fwd = s.profile(ARCH, phases=("fwd",), attn_impl=attn,
                        **kw).analyses["fwd"]
        assert _matmul(fwd) == want - (n_sites * qk_pv if attn == "flash"
                                       else 0)
        assert _custom(fwd, "ssd_scan") == (cfg.n_layers,
                                            cfg.n_layers * ssd)
        if attn == "flash":
            assert _custom(fwd, "flash_attention") == (
                n_sites, n_sites * p_flash_kernel.flops(
                    batch * cfg.n_heads, seq, seq, cfg.head_dim))
    if size == "smoke":
        bwd = {remat: _matmul(s.profile(ARCH, phases=("bwd",), remat=remat,
                                        **kw).analyses["bwd"])
               for remat in ("none", "full")}
        # the ssd_scan op's backward recomputes its plain math: more than
        # 2x the fwd's matmuls, the same with or without remat
        assert bwd["full"] == bwd["none"] > 3 * want


def test_remat_is_ignored_as_in_the_reference(smoke):
    params_np, tokens, targets = smoke
    model = p_api.build(p_get_smoke(ARCH))
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)}
    out = {}
    for remat in ("none", "full"):
        (loss, _), grads = p_step.value_and_grad(
            lambda p, b: model.loss_fn(p, b, p_base.RunConfig(
                amp="O0", remat=remat)), from_jax_numpy(params_np), batch)
        out[remat] = (loss, tree_flatten(grads)[0])
    assert out["none"][0] == out["full"][0]
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1],
                                                 out["full"][1]))


def test_from_jax_numpy_carries_the_hybrid_tree(smoke):
    params_np, _, _ = smoke
    tp = from_jax_numpy(params_np)
    assert set(tp) == {"embed", "ssm_blocks", "shared", "site_ln",
                       "site_ln_mlp", "ln_f"}
    assert set(tp["shared"]["mlp"]) == {"w_up", "w_down"}   # ungated gelu
    assert tp["site_ln"]["scale"].shape == (2, 64)
