"""The port's measured fused-vs-reference dispatch
(``repro_torch.tune.dispatch``, ``fusion="auto"``) against the
reference's ``repro.tune.dispatch`` — with deterministic fake timers:
nothing here times a kernel.

* dispatch key strings equal the reference's for the same op, shapes,
  dtypes and flags (the layernorm site included), so one tune store
  serves both packages;
* the miss policies (measure / static / frozen), the environment
  default, an unknown mode, ``force``;
* ``search_sites`` over the smoke glm4-9b train step finds the
  reference's set of sites, and a second search measures none;
* a ``fusion="auto"`` train step under ``frozen`` routes by the table:
  with every site stored ``reference`` it is the ``fusion="off"`` step,
  with every site ``fused`` the ``"static"`` one — bitwise, since on the
  host both routes run the same plain PyTorch versions;
* a miss inside the op walk measures on concrete tensors, outside the
  walk, and records none of the measurement's ops.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.tune import dispatch as r_dsp
from repro.tune.store import TuneStore as RTuneStore
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import get_smoke
from repro_torch.models import api as M
from repro_torch.tune import dispatch as dsp
from repro_torch.tune.store import TuneStore
from repro_torch.train.step import init_state, make_train_step


def fake_timer(walls):
    """Deterministic walls per impl; records what it was handed."""
    calls = []

    def timer(impl, fn, args, iters, warmup):
        calls.append((impl, args))
        return walls[impl]

    timer.calls = calls
    return timer


FUSED_WINS = {"fused": 1e-3, "reference": 2e-3}
REF_WINS = {"fused": 2e-3, "reference": 1e-3}


def _t(shape, dtype):
    return torch.empty(shape, dtype=dtype)


def _j(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


BF, F32, I32 = ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
                (torch.int32, jnp.int32))


@pytest.mark.parametrize("build", [
    # (port key, reference key) built from the same shapes and dtypes
    lambda: (dsp.norm_key(_t((4, 8, 64), BF[0]), _t((64,), F32[0])),
             r_dsp.norm_key(_j((4, 8, 64), BF[1]), _j((64,), F32[1]))),
    lambda: (dsp.norm_key(_t((32, 64), BF[0]), _t((64,), F32[0]),
                          kind="rmsnorm_residual"),
             r_dsp.norm_key(_j((32, 64), BF[1]), _j((64,), F32[1]),
                            kind="rmsnorm_residual")),
    lambda: (dsp.norm_key(_t((3, 5, 96), F32[0]), _t((96,), BF[0]),
                          _t((96,), BF[0]), kind="layernorm",
                          out_dtype=torch.bfloat16),
             r_dsp.norm_key(_j((3, 5, 96), F32[1]), _j((96,), BF[1]),
                            _j((96,), BF[1]), kind="layernorm",
                            out_dtype=jnp.bfloat16)),
    lambda: (dsp.swiglu_key(_t((2, 16, 224), BF[0]), _t((2, 16, 224), BF[0]),
                            act="gelu"),
             r_dsp.swiglu_key(_j((2, 16, 224), BF[1]),
                              _j((2, 16, 224), BF[1]), act="gelu")),
    lambda: (dsp.adamw_key(_t((2, 64, 224), F32[0]), _t((2, 64, 224), F32[0])),
             r_dsp.adamw_key(jnp.zeros((2, 64, 224)), jnp.zeros((2, 64, 224)))),
    lambda: (dsp.embed_key(_t((512, 64), F32[0]), _t((2, 16), I32[0]),
                           torch.bfloat16),
             r_dsp.embed_key(_j((512, 64), F32[1]), jnp.zeros((2, 16),
                                                              jnp.int32),
                             jnp.bfloat16)),
    lambda: (dsp.flash_key((2, 2048, 2, 16, 128), (2, 2048, 2, 128),
                           torch.bfloat16, chunk=1024),
             r_dsp.flash_key((2, 2048, 2, 16, 128), (2, 2048, 2, 128),
                             jnp.bfloat16, chunk=1024)),
    lambda: (dsp.make_key("fused_norm", [(8, 16), (16,)],
                          [torch.float32, "float32"],
                          {"kind": "layernorm", "out": "float32"},
                          machine="h100-sxm"),
             r_dsp.make_key("fused_norm", [(8, 16), (16,)],
                            [jnp.float32, "float32"],
                            {"kind": "layernorm", "out": "float32"},
                            machine="h100-sxm")),
])
def test_key_strings_equal_the_reference(build):
    mine, theirs = build()
    assert mine.key == theirs.key


def test_layernorm_and_rmsnorm_are_different_sites():
    x, s = _t((8, 16), F32[0]), _t((16,), F32[0])
    keys = {dsp.norm_key(x, s).key, dsp.norm_key(x, s, s, kind="layernorm").key,
            dsp.norm_key(x, s, kind="rmsnorm_residual").key,
            dsp.norm_key(x, s, out_dtype=torch.bfloat16).key}
    assert len(keys) == 4


def _key():
    return dsp.make_key("fused_norm", [(8, 16), (16,)], ["float32"] * 2,
                        {"kind": "layernorm", "out": "float32"})


def test_measure_persists_then_hits(tmp_path):
    store = TuneStore(str(tmp_path / "t.json"))
    timer = fake_timer(REF_WINS)
    with dsp.dispatch_scope(store=store, mode="measure", device="cpu",
                            timer=timer) as scope:
        assert dsp.decide(_key()) == "reference"
        assert dsp.decide(_key()) == "reference"
        assert (scope.n_measured, scope.n_hit) == (1, 1)
    assert sorted(i for i, _ in timer.calls) == ["fused", "reference"]
    # concrete inputs built from the key on the measuring device
    for _, args in timer.calls:
        assert [tuple(a.shape) for a in args] == [(8, 16), (16,), (16,)]
        assert all(a.device.type == "cpu" for a in args)
    rec = dsp.get_record(_key(), store)
    assert rec.impl == "reference" and rec.ref_wall_s == 1e-3
    assert rec.speedup == pytest.approx(2.0)
    assert RTuneStore(store.path).get_dispatch(_key().key)["impl"] == \
        "reference"


def test_static_routes_fused_without_timing(tmp_path):
    timer = fake_timer({})
    with dsp.dispatch_scope(store=str(tmp_path / "t.json"), mode="static",
                            timer=timer) as scope:
        assert dsp.decide(_key()) == "fused"
        assert scope.n_static == 1 and not timer.calls
    assert dsp.best_impl(_key(), str(tmp_path / "t.json")) is None


def test_frozen_raises_on_a_miss_and_serves_a_hit(tmp_path):
    path = str(tmp_path / "t.json")
    with dsp.dispatch_scope(store=path, mode="frozen"):
        with pytest.raises(dsp.DispatchMiss, match="frozen"):
            dsp.decide(_key())
    with dsp.dispatch_scope(store=path, mode="measure", device="cpu",
                            timer=fake_timer(FUSED_WINS)):
        dsp.decide(_key())
    with dsp.dispatch_scope(store=path, mode="frozen") as scope:
        assert dsp.decide(_key()) == "fused" and scope.n_hit == 1


def test_environment_sets_the_default_mode(tmp_path, monkeypatch):
    monkeypatch.setenv(dsp.DISPATCH_ENV, "static")
    with dsp.dispatch_scope(store=str(tmp_path / "t.json")) as scope:
        assert dsp.decide(_key()) == "fused" and scope.n_static == 1
    monkeypatch.setenv(dsp.DISPATCH_ENV, "frozen")
    with dsp.dispatch_scope(store=str(tmp_path / "t.json")):
        with pytest.raises(dsp.DispatchMiss):
            dsp.decide(_key())


def test_unknown_mode_is_rejected(tmp_path, monkeypatch):
    monkeypatch.setenv(dsp.DISPATCH_ENV, "sometimes")
    with dsp.dispatch_scope(store=str(tmp_path / "t.json")):
        with pytest.raises(ValueError, match="unknown REPRO_DISPATCH"):
            dsp.decide(_key())


def test_force_re_measures_once_per_scope(tmp_path):
    path = str(tmp_path / "t.json")
    with dsp.dispatch_scope(store=path, mode="measure", device="cpu",
                            timer=fake_timer(FUSED_WINS)):
        assert dsp.decide(_key()) == "fused"
    timer = fake_timer(REF_WINS)
    with dsp.dispatch_scope(store=path, mode="measure", device="cpu",
                            timer=timer, force=True) as scope:
        assert dsp.decide(_key()) == "reference"
        assert dsp.decide(_key()) == "reference"
        assert scope.n_measured == 1 and len(timer.calls) == 2
    assert dsp.best_impl(_key(), path) == "reference"


def _strip_machine(keys):
    return {k.rsplit("|", 1)[0] for k in keys}


def test_search_sites_finds_the_reference_sites(tmp_path):
    theirs = r_dsp.search_sites(
        "glm4-9b", seq=16, batch=2, store=RTuneStore(str(tmp_path / "r.json")),
        timer=fake_timer(REF_WINS))
    path = str(tmp_path / "p.json")
    timer = fake_timer(REF_WINS)
    mine = dsp.search_sites("glm4-9b", seq=16, batch=2, store=path,
                            timer=timer, device="cpu")
    assert mine.n_sites == theirs.n_sites == mine.n_measured == 10
    assert _strip_machine(r.key for r in mine.records) == \
        _strip_machine(r.key for r in theirs.records)
    assert {r.machine for r in mine.records} == {"cpu-host"}
    n_timed = len(timer.calls)
    again = dsp.search_sites("glm4-9b", seq=16, batch=2, store=path,
                             timer=timer, device="cpu")
    assert again.all_cached and again.n_sites == 10
    assert len(timer.calls) == n_timed
    # the AdamW sites follow the depth of the stacked leaves: the four
    # stacked sizes change, the embedding's and ln_f's do not
    deeper = dsp.search_sites("glm4-9b", seq=16, batch=2, store=path,
                              timer=timer, device="cpu", n_layers=3)
    assert deeper.n_measured == 4 and deeper.n_sites == 10


def _steps(run, n, store, mode="frozen"):
    cfg = get_smoke("glm4-9b")
    model = M.build(cfg)
    state = init_state(model, run, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    step = make_train_step(model, run)
    out = []
    with dsp.dispatch_scope(store=store, mode=mode):
        for _ in range(n):
            batch = M.synthetic_batch(cfg, ShapeSpec("t", 16, 2, "train"), 2,
                                      gen)
            state, metrics = step(state, batch)
            out.append(float(metrics["loss"]))
    return out, [t.clone() for t in tree_flatten(state.params)[0]]


@pytest.mark.parametrize("winner,twin", [("reference", "off"),
                                         ("fused", "static")])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_auto_step_routes_by_the_table(tmp_path, winner, twin, n_steps):
    path = str(tmp_path / "t.json")
    walls = REF_WINS if winner == "reference" else FUSED_WINS
    dsp.search_sites("glm4-9b", seq=16, batch=2, store=path,
                     timer=fake_timer(walls), device="cpu")
    assert {r.impl for r in dsp.dispatch_table(path)} == {winner}
    auto_losses, auto_params = _steps(RunConfig(fusion="auto"), n_steps,
                                      path)
    twin_losses, twin_params = _steps(RunConfig(fusion=twin), n_steps, path)
    assert auto_losses == twin_losses
    assert all(torch.equal(a, b) for a, b in zip(auto_params, twin_params))


def test_a_site_missing_from_the_table_fails_a_frozen_step(tmp_path):
    with pytest.raises(dsp.DispatchMiss):
        _steps(RunConfig(fusion="measured"), 1, str(tmp_path / "t.json"))


def test_a_miss_in_the_op_walk_measures_outside_it(tmp_path):
    from repro_torch.session.session import Session
    s = Session(device="cpu", workspace=str(tmp_path / "ws"))
    timer = fake_timer(REF_WINS)
    with dsp.dispatch_scope(mode="measure", timer=timer):
        walked = s.profile("glm4-9b", seq=16, batch=2, fusion="auto",
                           phases=("fwd", "bwd"))
    assert timer.calls
    for _, args in timer.calls:
        assert all(a.device.type == "cpu" for a in args)
    # a second walk, every site a store hit, records the same ops
    timer2 = fake_timer(REF_WINS)
    with dsp.dispatch_scope(mode="frozen", timer=timer2):
        again = s.profile("glm4-9b", seq=16, batch=2, fusion="auto",
                          phases=("fwd", "bwd"))
    assert not timer2.calls
    for ph in ("fwd", "bwd"):
        a, b = walked.analyses[ph], again.analyses[ph]
        assert [(k.opcode, k.exec_count) for k in a.kernels] == \
            [(k.opcode, k.exec_count) for k in b.kernels]
        assert a.total_flops == b.total_flops
    assert {r.machine for r in dsp.dispatch_table(s.workspace.tune_path)} \
        == {"cpu-host"}


def test_run_config_and_record_meta_carry_the_table(tmp_path):
    from repro_torch.session.session import Session
    s = Session(device="cpu", workspace=str(tmp_path / "ws"))
    with dsp.dispatch_scope(mode="measure", timer=fake_timer(FUSED_WINS)):
        rec = s.record("glm4-9b", seq=16, batch=2, fusion="auto", iters=1,
                       warmup=1)
    meta = rec.data.meta
    assert meta["fusion"] == "auto"
    assert set(meta["dispatch_table"]) == \
        {r.key for r in dsp.dispatch_table(s.workspace.tune_path)}
    assert all(v["impl"] == "fused" for v in meta["dispatch_table"].values())
    assert meta["kernel_configs"]["fused_norm"]["source"] == "default"
    back = s.report("glm4-9b").data.meta
    assert back["dispatch_table"] == meta["dispatch_table"]


def test_step_points_are_where_the_wrappers_look_up(tmp_path, monkeypatch):
    """``step_points`` names the (kernel, shape, dtype) at which the smoke
    step's wrappers ask ``for_launch`` for their config: the step runs at
    ``static`` on the host with each wrapper shimmed to record the point
    it passes."""
    from repro_torch.kernels.fused import adamw as ak
    from repro_torch.kernels.fused import common
    from repro_torch.kernels.fused import norm as nk
    from repro_torch.kernels.fused import swiglu as sk
    seen = set()

    def shim(mod, name, kernel, points):
        real = getattr(mod, name)

        def recording(*args, **kw):
            for dtype, shape in points(*args):
                seen.add((kernel, shape, dsp.dtype_name(dtype)))
            return real(*args, **kw)

        monkeypatch.setattr(mod, name, recording)

    def adamw_groups(gs, ms, vs, ps, *_):
        """One lookup per (g, m, v, p) dtype group, at its element
        count's size class (the power of two at or below it)."""
        total = {}
        for leaf in zip(gs, ms, vs, ps):
            key = tuple(t.dtype for t in leaf)
            total[key] = total.get(key, 0) + leaf[3].numel()
        return [(key[3], (1 << (n.bit_length() - 1),))
                for key, n in total.items()]

    for name in ("fused_rmsnorm", "fused_rmsnorm_residual"):
        shim(nk, name, "fused_norm",
             lambda x, *_: [(x.dtype, common.rows_view(x))])
    shim(sk, "fused_swiglu", "fused_swiglu",
         lambda g, *_: [(g.dtype, tuple(g.shape))])
    shim(ak, "fused_adamw_multi", "fused_adamw", adamw_groups)
    path = str(tmp_path / "t.json")
    _steps(RunConfig(fusion="static"), 1, path)
    points = dsp.step_points("glm4-9b", seq=16, batch=2, store=path,
                             device="cpu")
    assert {k for k, _, _ in points} == {"fused_norm", "fused_swiglu",
                                         "fused_adamw"}
    assert set(points) == seen and len(points) == len(seen)


@pytest.mark.parametrize("winner", ["reference", "fused"])
def test_step_points_follow_the_table(tmp_path, winner):
    """A site the table routes to ``reference`` launches no kernel, so it
    names no point; ``step_points`` measures nothing."""
    path = str(tmp_path / "t.json")
    before = dsp.step_points("glm4-9b", seq=16, batch=2, store=path,
                             device="cpu")
    assert not TuneStore(path).dispatch_records()
    dsp.search_sites("glm4-9b", seq=16, batch=2, store=path, device="cpu",
                     timer=fake_timer(REF_WINS if winner == "reference"
                                      else FUSED_WINS))
    after = dsp.step_points("glm4-9b", seq=16, batch=2, store=path,
                            device="cpu")
    assert after == ([] if winner == "reference" else before)
    # the norms', the SwiGLU's, and one lookup for the 12 AdamW leaves:
    # they launch together, one f32 group
    assert len(before) == 3
