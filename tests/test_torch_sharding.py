"""The port's sharding rules against the reference's, exactly.

``repro_torch.distributed.sharding`` produces one plain spec per tensor
(a tuple like a ``PartitionSpec``); every spec here must equal the
reference's ``PartitionSpec`` for the same tensor: every leaf of the
eleven registry configs' parameter trees at full size on both production
meshes under each shape's default run policy and the ``tp=False`` /
``fsdp=True`` / ``sp=True`` variants, the batch, KV-cache and decode-state
specs, the optimizer-state specs of AdamW and Adafactor, and the
reference's own rule cases (``tests/test_sharding.py``).  The reference
runs on its ``_fake_mesh`` (one host device repeated: the rules read only
the mesh's axis names and sizes); the port takes ``{axis: size}``.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec
from torch.utils._pytree import tree_flatten

from repro.configs import base as r_base
from repro.configs import registry as r_reg
from repro.distributed import sharding as r_shd
from repro.models import api as r_api
from repro.models import params as r_params
from repro.train import step as r_step
from repro_torch.configs import base as p_base
from repro_torch.configs import registry as p_reg
from repro_torch.distributed import sharding as p_shd
from repro_torch.models import api as p_api
from repro_torch.models import params as p_params
from repro_torch.train import step as p_step


def _reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices
    when imported; restore the environment so later subprocesses of this
    worker do not inherit it."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


R_DRY = _reference_dryrun()
from repro_torch.launch import dryrun as P_DRY  # noqa: E402


def _fake_mesh(shape=(4, 4), axes=("data", "model")) -> Mesh:
    devs = np.asarray([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    shape, axes = MESHES[kind]
    return _fake_mesh(shape, axes), dict(zip(axes, shape))


def _t(spec: PartitionSpec) -> tuple:
    return tuple(spec)


def _run_pair(run: r_base.RunConfig) -> p_base.RunConfig:
    return p_base.RunConfig(**{f.name: getattr(run, f.name)
                               for f in dataclasses.fields(p_base.RunConfig)
                               if hasattr(run, f.name)})


def _policies(arch):
    """(name, reference run, port run): each cell's default run, then the
    variants of the reference's default ``RunConfig``."""
    cfg_r, cfg_p = r_reg.get_config(arch), p_reg.get_config(arch)
    out = []
    for s in r_reg.cells(arch):
        rr = R_DRY.default_run(cfg_r, s)
        pr = P_DRY.default_run(cfg_p, p_base.SHAPES[s.name])
        assert _run_pair(rr) == pr
        out.append((f"default:{s.name}", rr, pr))
    for name, kw in (("tp_off", dict(tp=False)), ("fsdp", dict(fsdp=True)),
                     ("sp", dict(sp=True))):
        rr = r_base.RunConfig(**kw)
        out.append((name, rr, _run_pair(rr)))
    return out


ALL = p_reg.ALL                       # the eleven registry configs


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ALL)
def test_param_specs_equal_reference(arch, mesh_kind):
    r_mesh, p_mesh = _meshes(mesh_kind)
    r_spec = r_api.build(r_reg.get_config(arch)).spec
    p_spec = p_api.build(p_reg.get_config(arch)).spec
    r_leaves = jax.tree.leaves(r_spec, is_leaf=lambda x: isinstance(
        x, r_params.P))
    p_leaves = [p for _, p in p_params.leaves(p_spec)]
    assert [(p.shape, p.axes) for p in r_leaves] == \
        [(p.shape, p.axes) for p in p_leaves]
    policies = (_policies(arch) if arch in r_reg.ARCHS else
                [("default", r_base.RunConfig(), p_base.RunConfig())])
    for name, rr, pr in policies:
        want = [_t(r_shd.logical_to_spec(p, r_mesh, rr)) for p in r_leaves]
        tree = p_shd.param_shardings(p_spec, p_mesh, pr)
        got = tree_flatten(tree, is_leaf=p_shd._is_spec)[0]
        assert got == want, name


@pytest.mark.parametrize("arch", p_reg.ARCHS)
def test_batch_and_decode_specs_equal_reference(arch):
    for mesh_kind in MESHES:
        r_mesh, p_mesh = _meshes(mesh_kind)
        cfg_r, cfg_p = r_reg.get_config(arch), p_reg.get_config(arch)
        for rr in (r_base.RunConfig(), r_base.RunConfig(tp=False),
                   r_base.RunConfig(sp=True)):
            pr = _run_pair(rr)
            for rank in (2, 3):
                assert p_shd.batch_spec(p_mesh, pr, rank) == \
                    _t(r_shd.batch_spec(r_mesh, rr, rank))
            for bs in (1, 8, 256):
                assert p_shd.batch_spec(p_mesh, pr, batch_size=bs) == \
                    _t(r_shd.batch_spec(r_mesh, rr, batch_size=bs))
            assert p_shd.kv_cache_sharding(p_mesh, pr, cfg_p.n_kv_heads) \
                == _t(r_shd.kv_cache_sharding(r_mesh, rr,
                                              cfg_r.n_kv_heads).spec)
            for s in r_reg.cells(arch):
                ps = p_base.SHAPES[s.name]
                r_in = r_api.input_specs(cfg_r, s)
                p_in = p_api.synthetic_batch(cfg_p, ps, ps.global_batch,
                                             None, "meta")
                r_sh = r_shd.shard_batch_dim(r_in, r_mesh, rr)
                p_sh = p_shd.shard_batch_dim(p_in, p_mesh, pr)
                assert sorted(p_sh) == sorted(r_sh)
                for k in r_sh:
                    assert p_sh[k] == _t(r_sh[k].spec), (s.name, k)
            shape = r_base.SHAPES["decode_32k"]
            r_state = r_api.decode_state_specs(cfg_r, shape)
            p_state = p_api.decode_state_specs(cfg_p,
                                               p_base.SHAPES["decode_32k"])
            want = [_t(s.spec) for s in jax.tree.leaves(
                r_shd.decode_state_shardings(r_state, r_mesh, rr))]
            got = tree_flatten(p_shd.decode_state_shardings(
                p_state, p_mesh, pr), is_leaf=p_shd._is_spec)[0]
            assert got == want


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["glm4-9b", "kimi-k2-1t-a32b",
                                  "mamba2-1.3b", "deepcam"])
def test_opt_state_specs_equal_reference(arch, optimizer):
    for mesh_kind in MESHES:
        r_mesh, p_mesh = _meshes(mesh_kind)
        for fsdp in (False, True):
            rr = r_base.RunConfig(optimizer=optimizer, fsdp=fsdp)
            pr = _run_pair(rr)
            r_model = r_api.build(r_reg.get_config(arch))
            p_model = p_api.build(p_reg.get_config(arch))
            r_abs = r_step.abstract_state(r_model, rr)
            p_abs = p_step.init_state(p_model, pr, None, "meta")
            r_p = r_shd.param_shardings(r_model.spec, r_mesh, rr)
            p_p = p_shd.param_shardings(p_model.spec, p_mesh, pr)
            want = [_t(s.spec) for s in jax.tree.leaves(
                r_shd.opt_state_shardings(r_abs.opt, r_p, r_mesh))]
            got = tree_flatten(p_shd.opt_state_shardings(
                p_abs.opt, p_p, p_mesh), is_leaf=p_shd._is_spec)[0]
            assert got == want


@pytest.mark.parametrize("spec,rank,dropped", [
    (("data", "model"), 3, -1), (("data", "model"), 3, 0),
    ((None, "model"), 2, -1), ((("pod", "data"), None, "model"), 4, 2),
    ((), 2, 1)])
def test_reduced_spec_equal_reference(spec, rank, dropped):
    assert p_shd.reduced_spec(spec, rank, dropped) == \
        _t(r_shd.reduced_spec(PartitionSpec(*spec), rank, dropped))


# --------------------------------------------------------------------------
# The reference's rule cases (tests/test_sharding.py), one per parameter
# --------------------------------------------------------------------------

MESH = {"data": 4, "model": 4}
RUN = p_base.RunConfig()
P = p_params.P

LOGICAL_CASES = {
    "tp_shards_heads": (P((64, 8, 16), ("embed", "heads", "head_dim")),
                        RUN, (None, "model")),
    "divisibility_guard_replicates": (
        P((64, 6, 16), ("embed", "heads", "head_dim")), RUN, ("model",)),
    "embedding_table_never_row_sharded": (
        P((50277, 64), ("vocab", "embed")), RUN, ()),
    "fsdp_takes_first_free_dim": (
        P((64, 8, 16), ("embed", "heads", "head_dim")),
        p_base.RunConfig(fsdp=True), ("data", "model")),
    "experts_to_model": (P((8, 64, 32), ("experts", "embed", "expert_ffn")),
                         RUN, ("model",)),
    "layers_axis_never_sharded": (
        P((12, 64, 8, 16), ("layers", "embed", "heads", "head_dim")),
        p_base.RunConfig(fsdp=True), (None, "data", "model")),
    "tp_off_replicates": (P((64, 8, 16), ("embed", "heads", "head_dim")),
                          p_base.RunConfig(tp=False), ()),
}


@pytest.mark.parametrize("case", sorted(LOGICAL_CASES))
def test_logical_rules(case):
    p, run, want = LOGICAL_CASES[case]
    got = p_shd.logical_to_spec(p, MESH, run)
    assert got == want
    r_p = r_params.P(p.shape, p.axes)
    r_run = r_base.RunConfig(tp=run.tp, fsdp=run.fsdp)
    assert got == _t(r_shd.logical_to_spec(r_p, _fake_mesh(), r_run))


BATCH_CASES = {
    "batch_over_data": (MESH, RUN, {}, ("data", None)),
    "indivisible_batch_replicates": (MESH, RUN, {"batch_size": 1},
                                     (None, None)),
    "sp_shards_seq": (MESH, p_base.RunConfig(sp=True), {},
                      ("data", "model")),
    "multi_pod_axes": ({"pod": 2, "data": 2, "model": 2}, RUN, {},
                       (("pod", "data"), None)),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_specs(case):
    mesh, run, kw, want = BATCH_CASES[case]
    assert p_shd.batch_spec(mesh, run, **kw) == want


DECODE_CASES = {
    "kv_heads_preferred_over_seq": ((4, 8, 64, 8, 16),
                                    (None, "data", None, "model")),
    "seq_fallback_when_heads_indivisible": ((4, 8, 64, 2, 16),
                                            (None, "data", "model")),
    "scalar_length_replicated": ((), ()),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_state_shardings(case):
    shape, want = DECODE_CASES[case]
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert p_shd.decode_state_shardings(x, MESH, RUN) == want


def test_constrain_is_identity_without_a_mesh():
    x = torch.ones(4, 8)
    assert p_shd.constrain(x, RUN, "batch", None) is x


def test_activation_spec_follows_the_reference_rules():
    mesh = {"pod": 2, "data": 2, "model": 4}
    sp = p_base.RunConfig(sp=True)
    assert p_shd.activation_spec((8, 16, 32), mesh, RUN, "batch", "seq",
                                 None) == (("pod", "data"), None, None)
    assert p_shd.activation_spec((8, 16, 32), mesh, sp, "batch", "seq",
                                 None) == (("pod", "data"), "model", None)
    # a dim that does not divide its axis stays whole; an axis is used once
    assert p_shd.activation_spec((3, 16, 6), mesh, sp, "batch", "seq",
                                 "vocab") == (None, "model", None)


@pytest.mark.parametrize("arch,shape", [
    (a, s.name) for a, s in p_reg.all_cells()])
def test_model_flops_equal_reference(arch, shape):
    assert P_DRY.model_flops(p_reg.get_config(arch), p_base.SHAPES[shape]) \
        == R_DRY.model_flops(r_reg.get_config(arch), r_base.SHAPES[shape])


def test_cells_equal_reference():
    assert [(a, s.name) for a, s in p_reg.all_cells()] == \
        [(a, s.name) for a, s in r_reg.all_cells()]
    assert {k: dataclasses.astuple(v) for k, v in p_base.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in r_base.SHAPES.items()}


def test_grad_compression_names_its_item():
    """``grad_compression=True`` is accepted, as the reference's is, and
    read by nothing in either package's step (the scheme is
    ``repro_torch.distributed.compression``)."""
    run = p_base.RunConfig(grad_compression=True)
    ref = r_base.RunConfig(grad_compression=True)
    assert run.grad_compression and ref.grad_compression
    assert dataclasses.replace(run, grad_compression=False) == \
        p_base.RunConfig()
