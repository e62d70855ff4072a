"""The port's DeepCAM against the reference's, on the same parameters.

Parameters come from the reference's ``init`` (PRNGKey 0) at stem width 8,
handed over as numpy arrays through ``from_jax_numpy``; images and labels
are drawn with numpy.  Tolerances:

* a conv in fp32: 1e-5 of max|ref| (only the summation order differs);
* the bilinear resize: 1e-6 of max|ref| (the same taps and weights);
* O0 logits, and each leaf's gradient: 1e-4 of max|ref| (of that leaf),
  the reference's own tolerance between its two lowerings
  (``tests/test_models.py``); the loss rtol 1e-5.  Read here: 1.6e-6 for
  the logits, 2.6e-6 for the worst leaf;
* O1 logits (bf16 convs and activations): 3e-2 of max|ref| — bf16 rounds
  intermediates at other places in the two frameworks; read here: 1.1e-2
  and 1.2e-2 of max|ref| at the two shapes;
* params after one O0 train step: atol 2e-5, as ``test_torch_train.py``
  (AdamW's first step is about lr·sign(g));
* FLOP counts: exactly, with every difference named.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import flop_counter
from torch.utils._pytree import tree_flatten

from repro.configs import base as r_base
from repro.configs import deepcam as r_cfg
from repro.core import profile_fn as r_profile_fn
from repro.models import deepcam as r_dc
from repro.models import params as r_params
from repro.train import optim as r_optim
from repro_torch.bench import deepcam_roofline as bench
from repro_torch.configs import base as p_base
from repro_torch.configs import deepcam as p_cfg
from repro_torch.configs import registry as p_registry
from repro_torch.core import op_analysis as OA
from repro_torch.distributed import amp as p_amp
from repro_torch.models import api as p_api
from repro_torch.models import deepcam as p_dc
from repro_torch.models import params as p_params
from repro_torch.session.session import Session
from repro_torch.train import step as p_step

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 32, 48, 16), (2, *p_cfg.SMOKE_HW, 16))
LOGIT_TOL = {"O0": 1e-4, "O1": 3e-2}


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, 3, shape[:3]).astype(np.int32)
    return images, labels


@pytest.fixture(scope="module")
def ref_params():
    """The reference's width-8 params: (jax tree, numpy tree)."""
    spec = r_dc.deepcam_spec(8)
    params = jax.jit(lambda k: r_params.init(k, spec))(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


_REF: dict = {}


def _ref_impl(impl: str, amp: str) -> str:
    """At O0 the reference's two lowerings are one program (its
    ``astype(float32)`` around each norm is the identity on fp32), so
    their results are computed once."""
    return "reference" if amp == "O0" else impl


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) or 1.0
    return float(np.abs(np.asarray(got) - ref).max()) / scale


# --------------------------------------------------------------------------
# Config, spec tree and list nodes
# --------------------------------------------------------------------------

def test_config_copies_match_reference():
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(p_cfg, name)) == \
            dataclasses.asdict(getattr(r_cfg, name))
    assert p_cfg.IMAGE_HW == r_cfg.IMAGE_HW == (768, 1152)
    assert p_cfg.SMOKE_HW == r_cfg.SMOKE_HW
    assert p_registry.get_config("deepcam") is p_cfg.CONFIG
    assert p_registry.get_smoke("deepcam") is p_cfg.SMOKE
    assert "deepcam" not in p_registry.ARCHS


def _ref_paths(spec) -> list[str]:
    flat = jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=lambda x: isinstance(x, r_params.P))[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path) for path, _ in flat]


@pytest.mark.parametrize("width", [8, 64])
def test_spec_tree_matches_reference(width):
    r_spec, p_spec = r_dc.deepcam_spec(width), p_dc.deepcam_spec(width)
    desc = (lambda p: (tuple(p.shape), tuple(p.axes), p.init, p.scale))
    assert p_params.tree_map_specs(desc, p_spec) == jax.tree.map(
        desc, r_spec, is_leaf=lambda x: isinstance(x, r_params.P))
    assert isinstance(p_spec["stages"], list)
    assert all(isinstance(s, list) for s in p_spec["stages"])
    assert [p for p, _ in p_params.leaves(p_spec)] == _ref_paths(r_spec)
    assert p_params.count(p_spec) == r_params.count(r_spec)
    if width == 64:
        assert p_params.count(p_spec) == 41_593_491
        assert len(p_params.leaves(p_spec)) == 370


def test_list_nodes_round_trip(ref_params):
    spec = {"z": p_params.P((2,), (None,)),
            "a": [p_params.P((3,), (None,)),
                  {"y": p_params.P((1, 2), (None, None), "ones"),
                   "b": p_params.P((4,), (None,), "zeros")}]}
    assert [p for p, _ in p_params.leaves(spec)] == ["a/0", "a/1/b",
                                                     "a/1/y", "z"]
    t = p_params.init(spec, torch.Generator().manual_seed(0))
    assert isinstance(t["a"], list) and len(t["a"]) == 2
    assert list(t["a"][1]) == ["b", "y"]
    assert torch.equal(t["a"][1]["y"], torch.ones(1, 2))
    meta = p_params.init(spec, None, device="meta")
    assert isinstance(meta["a"], list) and meta["a"][0].is_meta
    # a reference tree crosses with its lists, leaves in jax's order
    _, np_tree = ref_params
    tp = p_params.from_jax_numpy(np_tree)
    assert isinstance(tp["stages"], list)
    assert [len(s) for s in tp["stages"]] == [3, 4, 6, 3]
    p_flat = tree_flatten(tp)[0]
    r_flat = jax.tree.leaves(np_tree)
    assert len(p_flat) == len(r_flat) == 370
    for p, r in zip(p_flat, r_flat):
        np.testing.assert_array_equal(p.numpy(), r)


def test_run_config_impl_is_validated_and_resolved():
    with pytest.raises(ValueError, match="impl"):
        p_base.RunConfig(impl="bogus")
    assert p_base.IMPLS == ("reference", "fused")
    assert p_base.RunConfig().impl == r_base.RunConfig().impl == "reference"
    for fusion in ("off", "static", "auto"):
        for impl in p_base.IMPLS:
            for explicit in (None, *p_base.IMPLS):
                got = p_dc.resolve_impl(
                    p_base.RunConfig(fusion=fusion, impl=impl), explicit)
                want = r_dc.resolve_impl(
                    r_base.RunConfig(fusion=fusion, impl=impl), explicit)
                assert got == want, (fusion, impl, explicit)
    assert p_dc.resolve_impl(p_base.RunConfig(fusion="auto")) == "fused"
    assert p_dc.resolve_impl(p_base.RunConfig(fusion="static")) == \
        "reference"


def test_batch_schema_and_synthetic_batch():
    shape = p_base.ShapeSpec("t", 4096, 2, "train")
    full = p_api.batch_schema(p_cfg.CONFIG, shape)
    assert full == {"images": ((2, 768, 1152, 16), torch.float32),
                    "labels": ((2, 768, 1152), torch.int32)}
    smoke = p_api.synthetic_batch(p_cfg.SMOKE, shape, 3,
                                  torch.Generator().manual_seed(0))
    assert smoke["images"].shape == (3, 64, 96, 16)
    assert smoke["labels"].dtype == torch.int32
    assert set(smoke["labels"].unique().tolist()) == {0, 1, 2}
    assert 0.015 < float(smoke["images"].std()) < 0.025
    meta = p_api.synthetic_batch(p_cfg.CONFIG, shape, 2, None, "meta")
    assert meta["images"].is_meta and meta["images"].shape[1:3] == (768,
                                                                    1152)


# --------------------------------------------------------------------------
# Ops against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(16, 24), (33, 47)])
@pytest.mark.parametrize("dilation", [1, 2, 6])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_matches_lax_same(k, stride, dilation, hw):
    rng = np.random.default_rng(k * 100 + stride * 10 + dilation)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, 3, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    ref = np.asarray(r_dc._conv(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                stride, dilation))
    got = p_dc._conv(torch.from_numpy(x),
                     {n: torch.from_numpy(v) for n, v in p.items()},
                     stride, dilation)
    assert got.shape == ref.shape
    assert _rel_err(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_bottleneck_without_projection_at_stride_2(impl):
    """The ``x[:, ::stride, ::stride]`` shortcut, which DeepCAM's stage
    plan never takes (every stride-2 block has a projection), on an odd
    size."""
    spec = r_dc._bottleneck_spec(8, 8)
    assert "proj" not in spec
    params = jax.jit(lambda k: r_params.init(k, spec))(jax.random.PRNGKey(1))
    x = np.random.default_rng(3).standard_normal((2, 9, 11, 8)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda p, x: r_dc._bottleneck(
        x, p, 2, 1, jnp.float32, impl == "fused"))(params, x))
    got = p_dc._bottleneck(
        torch.from_numpy(x),
        p_params.from_jax_numpy(jax.tree.map(np.asarray, params)), 2, 1,
        torch.float32, impl == "fused")
    assert got.shape == ref.shape == (2, 5, 6, 8)
    assert _rel_err(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("src,dst", [((8, 12), (16, 24)),
                                     ((6, 9), (24, 36)),
                                     ((5, 7), (12, 20))])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(0).standard_normal(
        (2, *src, 4)).astype(np.float32)
    ref = np.asarray(r_dc._resize(jnp.asarray(x), dst))
    got = p_dc._resize(torch.from_numpy(x), dst).numpy()
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= 1e-6


def test_resize_refuses_to_downsample():
    with pytest.raises(ValueError, match="upsamples only"):
        p_dc._resize(torch.zeros(1, 8, 12, 2), (4, 12))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("amp", ["O0", "O1"])
@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_logits_match_reference(ref_params, impl, amp, shape):
    params, np_params = ref_params
    images, _ = _data(shape)
    r_run, p_run = r_base.RunConfig(amp=amp), p_base.RunConfig(amp=amp)
    key = ("logits", _ref_impl(impl, amp), amp, shape)
    if key not in _REF:
        _REF[key] = np.asarray(jax.jit(lambda p, x: r_dc.deepcam_forward(
            p, x, r_run, key[1]))(params, images))
    ref = _REF[key]
    with torch.no_grad():
        got = p_dc.deepcam_forward(p_params.from_jax_numpy(np_params),
                                   torch.from_numpy(images), p_run, impl)
    assert got.dtype == torch.float32 and got.shape == (*shape[:3], 3)
    assert _rel_err(got.numpy(), ref) <= LOGIT_TOL[amp]


def _ref_grads(params, images, labels, impl: str):
    """The reference's O0 (loss, grads), computed once per lowering."""
    key = ("grads", _ref_impl(impl, "O0"))
    if key not in _REF:
        run = r_base.RunConfig(amp="O0")
        _REF[key] = jax.jit(jax.value_and_grad(lambda p: r_dc.deepcam_loss(
            p, images, labels, run, key[1])))(params)
    return _REF[key]


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_loss_and_every_gradient_match_reference_at_o0(ref_params, impl):
    params, np_params = ref_params
    images, labels = _data(SHAPES[0], seed=1)
    r_loss, r_grads = _ref_grads(params, images, labels, impl)
    p_run = p_base.RunConfig(amp="O0")
    (p_loss, _), p_grads = p_step.value_and_grad(
        lambda p, x, y: (p_dc.deepcam_loss(p, x, y, p_run, impl), {}),
        p_params.from_jax_numpy(np_params), torch.from_numpy(images),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=1e-5)
    paths = _ref_paths(r_dc.deepcam_spec(8))
    r_flat = jax.tree.leaves(r_grads)
    p_flat = tree_flatten(p_grads)[0]
    assert len(p_flat) == len(r_flat) == len(paths)
    stats = 0
    for path, p, r in zip(paths, p_flat, r_flat):
        assert _rel_err(p.numpy(), r) <= 1e-4, path
        if path.endswith(("/mean", "/var")):
            stats += 1
            assert float(np.abs(np.asarray(r)).max()) > 0, path
    assert stats == 2 * 59          # every BN's statistics got a gradient


def test_one_train_step_matches_reference(ref_params):
    """The port's train step (``fused`` lowering, ``fusion="static"``:
    every leaf routes through the fused AdamW op, its plain version on the
    host) against the reference's loss, gradients and AdamW update from the
    same state.  The reference's AdamW is elementwise and the same for
    every leaf, so it runs once over the concatenated leaves: one small
    program instead of 370.  Its Pallas AdamW needs a TPU compiler option
    this jax lacks; its fused math is the same function."""
    params, np_params = ref_params
    images, labels = _data(SHAPES[0], seed=1)
    r_loss, r_grads = _ref_grads(params, images, labels, "fused")

    def cat(tree):
        return {"all": jnp.concatenate([x.ravel()
                                        for x in jax.tree.leaves(tree)])}

    r_run = r_base.RunConfig(amp="O0")
    r_new, r_opt = jax.jit(lambda g, p: r_optim.adamw_update(
        g, r_optim.adamw_init(p, r_run), p))(cat(r_grads), cat(params))

    p_run = p_base.RunConfig(amp="O0", impl="fused", fusion="static")
    tp = p_params.from_jax_numpy(np_params)
    state = p_step.TrainState(tp, p_step.optim.optimizer_init(tp, p_run),
                              p_amp.DynLossScale.init(),
                              torch.zeros((), dtype=torch.int32))
    state, metrics = p_step.make_train_step(p_api.build(p_cfg.SMOKE), p_run)(
        state, {"images": torch.from_numpy(images),
                "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(metrics["loss"]), float(r_loss),
                               rtol=1e-5)
    r_norm = float(np.sqrt(np.sum(np.square(np.asarray(
        cat(r_grads)["all"], dtype=np.float64)))))
    np.testing.assert_allclose(float(metrics["grad_norm"]), r_norm,
                               rtol=1e-5)
    p_flat = tree_flatten(state.params)[0]
    assert len(p_flat) == 370 and p_flat[0] is tp["aspp"]["pool"]["b"]
    got = torch.cat([p.ravel() for p in p_flat]).numpy()
    np.testing.assert_allclose(got, np.asarray(r_new["all"]), atol=2e-5,
                               rtol=0)
    assert int(state.opt.count) == int(r_opt.count) == 1


# --------------------------------------------------------------------------
# Op-walk rules
# --------------------------------------------------------------------------

def _conv_ref_flops(b, ho, wo, k, cin, cout) -> int:
    return 2 * b * ho * wo * k * k * cin * cout


@pytest.mark.parametrize("dtype,cls", [(torch.bfloat16, "bf16"),
                                       (torch.float32, "f32")])
def test_conv_rule_counts_flop_counter_formula(dtype, cls):
    """A strided, dilated, biased conv: the forward at flop_counter's
    2·B·H_out·W_out·k²·c_in·c_out (no bias term), the backward at one such
    count for each gradient its ``output_mask`` asks for."""
    x = torch.randn(2, 5, 17, 23, dtype=dtype)
    w = torch.randn(7, 5, 3, 3, dtype=dtype)
    b = torch.randn(7, dtype=dtype)
    kw = dict(stride=2, padding=2, dilation=2)
    ho, wo = F.conv2d(x, w, b, **kw).shape[2:]
    one = _conv_ref_flops(2, ho, wo, 3, 5, 7)

    def step(x, w, b, need_x):
        with torch.enable_grad():
            xs = x.requires_grad_(need_x)
            ws = w.requires_grad_()
            y = F.conv2d(xs, ws, b, **kw)
            return torch.autograd.grad(y.sum(), [xs, ws] if need_x
                                       else [ws])

    for need_x, n in ((True, 2), (False, 1)):
        ana = OA.analyze_fn(lambda *a: step(*a, need_x), (x, w, b))
        recs = {k.opcode: k for k in ana.kernels if k.category == "conv"}
        assert recs["convolution"].flops == one
        assert recs["convolution_backward"].flops == n * one
        assert set(recs["convolution"].flops_by_class) == {cls}
        fn = flop_counter.flop_registry[torch.ops.aten.convolution]
        assert fn(x, w, b, (2, 2), (2, 2), (2, 2), False, (0, 0), 1,
                  out_val=torch.empty(2, 7, ho, wo)) == one
    # f32 operands take the AMP policy's class, as matmuls do
    ana = OA.analyze_fn(lambda x, w: F.conv2d(x, w), (x.float(), w.float()),
                        matmul_class="bf16")
    assert set(ana.kernels[0].flops_by_class) == {"bf16"}


def test_upsample_rule_counts_per_output_element():
    x = torch.randn(2, 4, 6, 9)

    def fwd_bwd(x):
        with torch.enable_grad():
            xs = x.requires_grad_()
            y = F.interpolate(xs, size=(12, 18), mode="bilinear",
                              align_corners=False)
            return torch.autograd.grad(y.sum(), [xs])

    ana = OA.analyze_fn(fwd_bwd, (x,))
    recs = {k.opcode: k for k in ana.kernels}
    n_out = 2 * 4 * 12 * 18
    assert recs["upsample_bilinear2d"].flops == OA.UPSAMPLE_FLOPS * n_out
    assert recs["upsample_bilinear2d_backward"].flops == \
        OA.UPSAMPLE_BWD_FLOPS * n_out
    assert OA.UPSAMPLE_FLOPS == 9 and OA.UPSAMPLE_BWD_FLOPS == 12
    assert {recs[k].category for k in recs if k.startswith("upsample")} == \
        {"elementwise"}


# --------------------------------------------------------------------------
# Phase walks: counts against the analytic count and the reference's HLO
# --------------------------------------------------------------------------

def _conv_flops(analysis) -> float:
    return sum(k.total_flops for k in analysis.kernels if k.category == "conv")


def _port_walks(width: int, amp: str = "O1", impl: str = "reference"):
    """Meta walks of the port's fwd, bwd and opt phases at ``width`` on
    SMOKE_HW, batch 2."""
    from repro_torch.train.step import make_phases
    cfg = dataclasses.replace(p_cfg.SMOKE, d_model=width)
    run = p_base.RunConfig(amp=amp, impl=impl)
    model = p_api.build(cfg)
    params = p_params.init(model.spec, None, device="meta")
    batch = {"images": torch.empty(2, *p_cfg.SMOKE_HW, 16, device="meta"),
             "labels": torch.empty(2, *p_cfg.SMOKE_HW, dtype=torch.int32,
                                   device="meta")}
    fns = make_phases(model, run)
    opt_args = (params, params, p_step.optim.optimizer_init(params, run))
    return {ph: OA.analyze_fn(fns[ph], opt_args if ph == "opt"
                              else (params, batch), matmul_class="bf16")
            for ph in ("fwd", "bwd", "opt")}


@pytest.fixture(scope="module")
def bench_walk():
    """The benchmark's walks (width 8, SMOKE_HW, batch 2, O1, both
    lowerings) against ``h100-sxm``: {"<impl>/<phase>": ProfileResult}."""
    return bench.walk(device="cpu")[0]


@pytest.fixture(scope="module")
def walks64():
    return _port_walks(64)


@pytest.mark.parametrize("width", [8, 64])
def test_phase_conv_flops_equal_the_analytic_count(width, bench_walk,
                                                   walks64):
    walks = walks64 if width == 64 else {
        ph: bench_walk[f"reference/{ph}"].analysis
        for ph in ("fwd", "bwd", "opt")}
    want = p_dc.conv_flops(width, p_cfg.SMOKE_HW, 2)
    _, h, w, k, cin, cout, _ = p_dc.conv_plan(width, p_cfg.SMOKE_HW)[0]
    stem_dgrad = _conv_ref_flops(2, h, w, k, cin, cout)
    assert len(p_dc.conv_plan(width, p_cfg.SMOKE_HW)) == 67
    assert _conv_flops(walks["fwd"]) == want
    assert _conv_flops(walks["bwd"]) == 3 * want - stem_dgrad
    assert _conv_flops(walks["opt"]) == 0
    assert walks["opt"].total_flops > 0
    n_conv = sum(k.exec_count for k in walks["fwd"].kernels
                 if k.opcode == "convolution")
    assert n_conv == 67
    if width == 8:
        fused = bench_walk["fused/fwd"].analysis
        assert _conv_flops(fused) == want


@pytest.fixture(scope="module")
def reference_hlo_counts():
    """The reference's conv + matmul FLOPs and its resize dots' FLOPs,
    fwd and bwd, at width 64 on SMOKE_HW, batch 2, O1 (abstract shapes:
    compiled, not run)."""
    params = r_params.abstract(r_dc.deepcam_spec(64))
    images = jax.ShapeDtypeStruct((2, *r_cfg.SMOKE_HW, 16), jnp.float32)
    labels = jax.ShapeDtypeStruct((2, *r_cfg.SMOKE_HW), jnp.int32)
    run = r_base.RunConfig(amp="O1")

    def fwd(p, x, y):
        return r_dc.deepcam_loss(p, x, y, run)

    def bwd(p, x, y):
        return jax.grad(fwd)(p, x, y)

    out = {}
    for ph, fn in (("fwd", fwd), ("bwd", bwd)):
        kernels = r_profile_fn(fn, args=(params, images, labels),
                               machine="cpu-host",
                               matmul_class="bf16").analysis.kernels
        dense = sum(k.total_flops for k in kernels
                    if k.category in ("conv", "matmul"))
        resize = sum(k.total_flops for k in kernels
                     if k.category == "matmul" and "_resize" in k.op_name)
        out[ph] = (dense, resize)
    return out


def test_conv_flops_match_the_reference_hlo_count(reference_hlo_counts,
                                                  walks64):
    """XLA lowers every stride-1 1×1 conv to a dot (category ``matmul``),
    so the port's conv FLOPs are held against the reference's conv +
    matmul FLOPs, less the dots ``jax.image.resize`` lowers to (two per
    resize, with dense interpolation matrices; the port's upsample counts
    9 FLOPs an output element, category ``elementwise``).  The forward
    then agrees exactly.  The backward differs by exactly the zeros of the
    strided convs' input gradients: XLA computes that gradient as a conv
    over the ``lhs_dilation``-dilated output gradient and counts the
    inserted zeros — 4× the forward's FLOPs at stride 2 where
    ``convolution_backward`` counts 1× —, for every stride-2 conv but the
    stem, whose input (the images) takes no gradient."""
    (r_fwd, r_fwd_resize), (r_bwd, r_bwd_resize) = (
        reference_hlo_counts["fwd"], reference_hlo_counts["bwd"])
    assert r_fwd_resize > 0 and r_bwd_resize == 2 * r_fwd_resize
    assert _conv_flops(walks64["fwd"]) == r_fwd - r_fwd_resize
    zeros = sum(3 * _conv_ref_flops(2, h, w, k, cin, cout)
                for name, h, w, k, cin, cout, s in
                p_dc.conv_plan(64, p_cfg.SMOKE_HW)
                if s == 2 and name != "stem")
    assert zeros > 0
    assert _conv_flops(walks64["bwd"]) == r_bwd - r_bwd_resize - zeros


@pytest.mark.parametrize("phase", ["fwd", "bwd"])
def test_lowerings_differ_in_traffic_mix_under_amp(bench_walk, phase):
    """Paper Table III in the port: under O1 the ``reference`` lowering's
    fp32 round trips around every norm add zero-AI launches and bytes that
    the ``fused`` lowering's folded norms do not have."""
    ref, fused = (bench_walk[f"{impl}/{phase}"].analysis
                  for impl in p_base.IMPLS)
    (z_ref, zb_ref), (z_fused, zb_fused) = (
        a.zero_ai_census()["zero-AI"] for a in (ref, fused))
    assert z_ref > 1.05 * z_fused
    assert zb_ref > 1.05 * zb_fused
    assert ref.total_hbm_bytes > 1.05 * fused.total_hbm_bytes


def test_bench_rows_match_the_reference_verdicts(bench_walk):
    rows = {name: (us, derived) for name, us, derived in
            bench.rows_of(bench_walk)}
    for impl in ("reference", "fused"):
        for ph in ("fwd", "bwd", "opt"):
            assert rows[f"deepcam_roofline/{impl}_{ph}"][1].startswith(
                "dom=")
    assert rows["deepcam_roofline/bwd_gt_fwd_flops"][1] == "True"
    assert rows["deepcam_roofline/opt_memory_bound"][1] == "memory"
    conv = float(rows["deepcam_roofline/conv_flop_share"][1])
    with_resize = float(rows["deepcam_roofline/conv_resize_flop_share"][1])
    assert 0.9 < conv <= with_resize <= 1.0


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


def test_cli_profiles_deepcam_on_the_host():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "profile", "--config",
         "deepcam", "--smoke", "--device", "cpu", "--impl", "fused"],
        cwd=REPO_ROOT, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "-- fwd --" in proc.stdout and "-- opt --" in proc.stdout
    assert "conv" in proc.stdout


def test_record_reads_back_through_the_reference_store(tmp_path):
    from repro.trace.store import TraceStore
    s = Session(machine="cpu-host", device="cpu",
                workspace=str(tmp_path / "ws"))
    res = s.record("deepcam", batch=1, impl="fused", iters=1, warmup=1)
    assert s.report("deepcam").data.run_id == res.data.run_id
    rec = TraceStore(s.workspace.trace_path).last("deepcam", n=1)[0]
    assert rec.run_id == res.data.run_id
    assert rec.meta["impl"] == "fused"
    assert set(rec.phases) == {"fwd", "bwd", "opt"}
    assert json.loads(json.dumps(rec.meta))["smoke"] is True
