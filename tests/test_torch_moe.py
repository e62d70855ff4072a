"""The MoE family — granite-moe-1b-a400m (32 experts top-8) and
kimi-k2-1t-a32b (384 experts top-8 and a shared expert) — against the
reference on the same parameters.

Parameters and train states are made by the reference (PRNGKey 0) and
carried over by ``from_jax_numpy``; tokens and activations are drawn
with numpy.  The reference runs at ``fusion="off"`` and its flash route
as its plain ``_ref_gqa`` (its Pallas kernels do not compile on this
jax, ``test_torch_attention.py``); the port at ``off`` and ``static``,
where the routed ops run their plain versions on the host.

* Routing is exact: the same slots, tokens and kept set, with experts
  that overflow too (``capacity_factor`` lowered in both packages);
  gates and the aux terms within 1e-6 (fp32 softmax and top-k in two
  frameworks).
* ``moe_apply`` at O0 within 1e-5 of max|ref| (an fp32 sum of K terms in
  another order), at O1 within 2 bf16 ulps of max|ref|: the reference
  scatter-adds each token's K terms in bf16 in sorted order, the port
  sums them with an fp32 accumulator and rounds once (``models/moe.py``).
* Logits and loss: ``test_torch_model.py``'s tolerances, O0 atol 1e-4
  and loss rtol 1e-5; O1 atol 6e-2 (``test_torch_dense_family.py``'s:
  bf16 rounds at other places; read up to 0.039 here) and rtol 1e-2.
* The train step (``test_torch_moe_step.py``, with the walks):
  ``test_torch_train.py``'s tolerances after steps 1
  and 3, but at O1 the moments of the MoE leaves and of ``ln_mlp``
  (whose gradient flows through the experts) within 0.1 of their norm
  (:data:`O1_MOE_MOM_TOL`), not 5e-2: the experts' bf16 products at
  width 64 put each package's O1 gradients 5–8% from its own fp32 ones
  (reference 0.077 on ``ln_mlp``, port 0.068, port against reference
  0.060), which ``test_o1_gradients_stay_near_the_o0_ones`` holds.
* The walk's matmul FLOPs equal the reference's HLO count and
  ``transformer.matmul_flops`` (experts over the capacity-padded E·C
  slots of each group, the router 2·B·S·D·E) per remat mode exactly.
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
from repro.models import moe as r_moe
from repro.models import params as r_params
from repro_torch.configs import base as p_base
from repro_torch.configs.registry import get_config as p_get_config
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.models import api as p_api
from repro_torch.models import moe as p_moe
from repro_torch.models.params import from_jax_numpy

ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")
TOL = {"O0": (1e-4, 1e-5), "O1": (6e-2, 1e-2)}
O1_MOE_MOM_TOL = 0.1
MOE_LEAVES = ("blocks/moe/", "blocks/ln_mlp/")
ROUTES = ("einsum", "chunked", "flash")


@pytest.fixture
def ref_flash_is_plain(monkeypatch):
    monkeypatch.setattr(
        r_fa_ops, "flash_attention_gqa",
        lambda q, k, v: r_fa_ops._ref_gqa(q, k, v, True))


def _params(cfg):
    params = r_params.init(jax.random.PRNGKey(0), r_api.build(cfg).spec,
                           jnp.float32)
    return jax.tree.map(np.asarray, params)


def _tokens(seed: int, shape=(2, 32)) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 512, shape, dtype=np.int32)
            for k in ("tokens", "targets")}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    """Field for field at full and smoke size; ``param_count`` and
    ``active_param_count`` equal the reference's, and the spec tree holds
    the count's leaves (the embedding at the padded vocabulary)."""
    for r_cfg, p_cfg in ((r_get_config(arch), p_get_config(arch)),
                         (r_get_smoke(arch), p_get_smoke(arch))):
        assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
        assert p_cfg.param_count() == r_cfg.param_count()
        assert p_cfg.active_param_count() == r_cfg.active_param_count()
        assert p_cfg.active_param_count() < p_cfg.param_count()
        from repro_torch.models.params import count
        pad = (p_cfg.vocab_padded - p_cfg.vocab_size) * p_cfg.d_model * (
            1 if p_cfg.tie_embeddings else 2)
        assert count(p_api.build(p_cfg).spec) == p_cfg.param_count() + pad
    assert p_get_config("granite-moe-1b-a400m").param_count() == \
        1_334_628_352


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch):
    r_leaves = jax.tree_util.tree_flatten_with_path(
        r_api.build(r_get_smoke(arch)).spec,
        is_leaf=lambda x: isinstance(x, r_params.P))[0]
    from repro_torch.models.params import leaves
    p_leaves = leaves(p_api.build(p_get_smoke(arch)).spec)
    assert [tuple(p.shape) for _, p in p_leaves] == \
        [tuple(s.shape) for _, s in r_leaves]
    assert [p.init for _, p in p_leaves] == [s.init for _, s in r_leaves]


@pytest.mark.parametrize("S", [1, 7, 8, 13, 32, 256, 2048])
@pytest.mark.parametrize("arch", ARCHS + ("cf-0.5",))
def test_capacity_matches_reference(arch, S):
    r_cfg, p_cfg = _pair(arch)
    assert p_moe._capacity(S, p_cfg) == r_moe._capacity(S, r_cfg)


def _pair(arch: str):
    """(reference, port) smoke configs; ``cf-0.5`` is granite-moe's with
    ``capacity_factor`` 0.5, so that experts overflow."""
    if arch == "cf-0.5":
        return tuple(dataclasses.replace(get("granite-moe-1b-a400m"),
                                         capacity_factor=0.5)
                     for get in (r_get_smoke, p_get_smoke))
    return r_get_smoke(arch), p_get_smoke(arch)


@pytest.mark.parametrize("S", [8, 32, 96])
@pytest.mark.parametrize("arch", ARCHS + ("cf-0.5",))
def test_route_group_matches_reference(arch, S):
    """One group's slots, tokens and kept set exactly; gates and the aux
    terms within 1e-6.  At cf 0.5 (and at kimi's 8 experts of capacity 8
    at S = 96) some choices overflow: they take row E·C and gate 0 in
    both, and the stable sort drops the same (latest) tokens."""
    r_cfg, p_cfg = _pair(arch)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((S, r_cfg.d_model), np.float32)
    router = rng.standard_normal((r_cfg.d_model, r_cfg.n_experts),
                                 np.float32) * 0.3
    C = r_moe._capacity(S, r_cfg)
    r = [np.asarray(a) for a in jax.jit(
        lambda x, w: r_moe._route_group(x, w, r_cfg, C))(
            jnp.asarray(x), jnp.asarray(router))]
    p = [a.numpy() for a in p_moe._route_group(
        torch.from_numpy(x), torch.from_numpy(router), p_cfg, C)[:5]]
    np.testing.assert_array_equal(p[0], r[0])                  # slots
    np.testing.assert_array_equal(p[1], r[1])                  # tokens
    kept = r[0] < r_cfg.n_experts * C
    np.testing.assert_array_equal(p[2] != 0, kept)
    for a, b in zip(p[2:], r[2:]):                             # gate, me, ce
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    if arch == "cf-0.5" and S >= 32:
        assert not kept.all()


def test_route_group_runs_over_groups_on_meta():
    """The leading dims are groups, each routed alone: a (3, S, D) batch
    gives each group's single-group result; and the route runs on meta
    tensors (no bincount, nothing read back)."""
    cfg = p_get_smoke("granite-moe-1b-a400m")
    x = torch.randn(3, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    router = torch.randn(cfg.d_model, cfg.n_experts) * 0.3
    C = p_moe._capacity(16, cfg)
    out = p_moe._route_group(x, router, cfg, C)
    for g in range(3):
        one = p_moe._route_group(x[g], router, cfg, C)
        for a, b in zip(out, one):
            torch.testing.assert_close(a[g], b, rtol=0, atol=0)
    meta = p_moe._route_group(x.to("meta"), router.to("meta"), cfg, C)
    assert [tuple(t.shape) for t in meta] == [tuple(t.shape) for t in out]


def test_routing_tape_records_and_replays():
    """A ``RoutingTape`` records each routing call's probabilities and
    top-k experts; replayed, a call takes the recorded experts instead of
    its own, with its own probabilities as gates, and the slots and tokens
    follow the experts.  Outside a tape nothing is recorded, and two tapes
    cannot be active at once."""
    cfg = p_get_smoke("granite-moe-1b-a400m")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=g) * 0.3
    other = torch.randn(cfg.d_model, cfg.n_experts, generator=g) * 0.3
    C = p_moe._capacity(16, cfg)
    with p_moe.RoutingTape() as tape:
        ref = p_moe._route_group(x, router, cfg, C)
    assert p_moe._TAPE is None and len(tape.calls) == 1
    probs = torch.softmax(x @ router, -1)
    torch.testing.assert_close(tape.calls[0]["probs"], probs)
    assert tuple(tape.calls[0]["experts"].shape) == (
        2, 16, cfg.experts_per_token)
    with p_moe.RoutingTape(replay=tape.calls) as again:
        same = p_moe._route_group(x, router, cfg, C)
    for a, b in zip(same, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    free = p_moe._route_group(x, other, cfg, C)
    with p_moe.RoutingTape(replay=tape.calls) as again:
        pinned = p_moe._route_group(x, other, cfg, C)
    assert not torch.equal(free[0], ref[0])
    assert torch.equal(again.calls[0]["experts"], tape.calls[0]["experts"])
    assert torch.equal(pinned[0], ref[0]) and torch.equal(pinned[1], ref[1])
    own = torch.gather(torch.softmax(x @ other, -1), -1,
                       tape.calls[0]["experts"])
    own = (own / own.sum(-1, keepdim=True)).flatten(-2)
    kept = pinned[0] < cfg.n_experts * C
    torch.testing.assert_close(pinned[2], torch.where(
        kept, torch.gather(own, -1, pinned[5]), 0.0))
    with p_moe.RoutingTape():
        with pytest.raises(RuntimeError, match="already active"):
            p_moe.RoutingTape().__enter__()
    with p_moe.RoutingTape(replay=tape.calls):
        with pytest.raises(ValueError, match="replayed call 0"):
            p_moe._route_group(x[:1], router, cfg, C)


def _ulp_close(got, want, ulps: float) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = ulps * 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("arch", ARCHS + ("cf-0.5",))
def test_moe_apply_matches_reference(arch, amp):
    """Output and aux of one MoE block on (2, 32, D) activations: O0 within
    1e-5 of max|ref|, O1 within 2 bf16 ulps of it; aux within 1e-6."""
    r_cfg, p_cfg = _pair(arch)
    spec = r_moe.moe_spec(r_cfg)
    pr = jax.tree.map(np.asarray, r_params.init(jax.random.PRNGKey(1), spec,
                                                jnp.float32))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, r_cfg.d_model), np.float32)
    r_run, p_run = r_base.RunConfig(amp=amp), p_base.RunConfig(amp=amp)
    cd = r_run.compute_dtype
    ry, raux = jax.jit(lambda p, x: r_moe.moe_apply(p, x, r_cfg, r_run))(
        jax.tree.map(jnp.asarray, pr), jnp.asarray(x, cd))
    with torch.no_grad():
        py, paux = p_moe.moe_apply(from_jax_numpy(pr),
                                   torch.from_numpy(x).to(p_run.compute_dtype),
                                   p_cfg, p_run)
    assert py.dtype == p_run.compute_dtype and paux.dtype == torch.float32
    if amp == "O0":
        scale = np.abs(np.asarray(ry)).max()
        np.testing.assert_allclose(py.numpy(), np.asarray(ry),
                                   atol=1e-5 * scale, rtol=0)
    else:
        _ulp_close(py.float().numpy(), ry, 2)
    np.testing.assert_allclose(float(paux), float(raux), atol=1e-6, rtol=0)


@pytest.mark.parametrize("combine", ["default", "reshard", "a2a"])
def test_moe_combine_values_compute_one_function(combine):
    """The reference's three ``moe_combine`` values are accepted; on one
    device each is the same function (the reference's differ only in
    sharding annotations)."""
    cfg = p_get_smoke("granite-moe-1b-a400m")
    p = from_jax_numpy(jax.tree.map(np.asarray, r_params.init(
        jax.random.PRNGKey(1), r_moe.moe_spec(r_get_smoke(
            "granite-moe-1b-a400m")), jnp.float32)))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        base = p_moe.moe_apply(p, x, cfg, p_base.RunConfig(amp="O0"))
        got = p_moe.moe_apply(p, x, cfg, p_base.RunConfig(
            amp="O0", moe_combine=combine))
    for a, b in zip(got, base):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="moe_combine"):
        p_base.RunConfig(moe_combine="bogus")


# (amp, attn_impl, fusion): every route at O0, einsum at O1, and flash
# at O0 under ``static`` (the routed ops' plain versions on the host)
CASES = ([("O0", impl, "off") for impl in ROUTES]
         + [("O1", "einsum", "off"), ("O0", "flash", "static")])


@pytest.mark.parametrize("amp,impl,fusion", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(ref_flash_is_plain, arch, amp, impl,
                                         fusion):
    """Logits, loss and its ``aux`` / ``ce`` metrics of the smoke model at
    seq 32 under each attention route (``chunked`` at chunks of 16)."""
    r_cfg, p_cfg = _pair(arch)
    params = _params(r_cfg)
    b = _tokens(7)
    r_run = r_base.RunConfig(amp=amp, attn_impl=impl, attn_chunk=16)
    p_run = p_base.RunConfig(amp=amp, attn_impl=impl, attn_chunk=16,
                             fusion=fusion)
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    r_logits = jax.jit(lambda p, b: r_model.forward_fn(p, b, r_run))(jp, jb)
    r_loss, r_met = jax.jit(lambda p, b: r_model.loss_fn(p, b, r_run))(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tp = from_jax_numpy(params)
    with torch.no_grad():
        p_logits = p_model.forward_fn(tp, tb, p_run)
        p_loss, p_met = p_model.loss_fn(tp, tb, p_run)
    atol, rtol = TOL[amp]
    np.testing.assert_allclose(p_logits.float().numpy(),
                               np.asarray(r_logits, np.float32), atol=atol,
                               rtol=0)
    assert set(p_met) == set(r_met) == {"loss", "ce", "aux"}
    for k in p_met:
        np.testing.assert_allclose(float(p_met[k]), float(r_met[k]),
                                   rtol=rtol)
    np.testing.assert_allclose(float(p_loss), float(p_met["ce"])
                               + 0.01 * float(p_met["aux"]), rtol=1e-6)


def test_moe_walk_reads_nothing_back():
    """The MoE block runs on meta tensors whole (the op walk), with the
    per-expert counts as a scatter-add: no bincount, no host read."""
    cfg = p_get_smoke("granite-moe-1b-a400m")
    run = p_base.RunConfig(amp="O1")
    from repro_torch.models.params import init
    p = init(p_moe.moe_spec(cfg), None, torch.float32, "meta")
    x = torch.empty(2, 32, cfg.d_model, dtype=torch.bfloat16, device="meta")
    ana = analyze_fn(lambda p, x: p_moe.moe_apply(p, x, cfg, run), (p, x))
    ops = {k.opcode for k in ana.kernels}
    assert not any("bincount" in o for o in ops), ops
    assert any("scatter_add" in o for o in ops), ops


@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, amp):
    """Ten steps from a zero cache of 8 rows, batch 2 (each slot's token
    a group of its own): logits and both caches after every step."""
    from test_torch_decode import _step_both, _zeros
    r_cfg, p_cfg = _pair(arch)
    r_model, p_model = r_api.build(r_cfg), p_api.build(p_cfg)
    params = r_params.init(jax.random.PRNGKey(0), r_model.spec, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    _step_both(r_model, p_model, params, tp,
               _zeros(r_model.init_state_fn(2, 8)), amp, 10,
               r_cfg.vocab_size, 2)


def test_decode_matches_forward_below_the_capacity():
    """The stepwise decode ≡ the forward over the same 8 tokens (O0): at
    8 tokens no expert of 8 slots can overflow, so both group the tokens
    without a drop and compute one function."""
    cfg = p_get_smoke("granite-moe-1b-a400m")
    model = p_api.build(cfg)
    tp = from_jax_numpy(_params(r_get_smoke("granite-moe-1b-a400m")))
    run = p_base.RunConfig(amp="O0")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 8), dtype=np.int32))
    state = model.init_state_fn(1, 16, torch.float32, device="cpu")
    outs = []
    with torch.no_grad():
        full = model.forward_fn(tp, {"tokens": tokens}, run)
        for t in range(8):
            lg, state = model.decode_fn(tp, {"tokens": tokens[:, t:t + 1]},
                                        state, run)
            outs.append(lg[:, 0])
    assert p_moe._capacity(8, cfg) == 8
    assert p_moe._capacity(2048, p_get_config("granite-moe-1b-a400m")) == 640
    err = (torch.stack(outs, 1) - full).abs().max().item()
    assert err < 1e-4, err


def test_param_leaves_match_the_reference_after_init():
    """``from_jax_numpy`` carries the reference's MoE tree: every leaf by
    path, with the expert stacks (L, E, D, F)."""
    params = _params(r_get_smoke("kimi-k2-1t-a32b"))
    tp = from_jax_numpy(params)
    cfg = p_get_smoke("kimi-k2-1t-a32b")
    moe = tp["blocks"]["moe"]
    assert tuple(moe["w_gate"].shape) == (cfg.n_layers, cfg.n_experts,
                                          cfg.d_model, cfg.d_ff)
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert len(tree_flatten(tp)[0]) == len(jax.tree.leaves(params))
