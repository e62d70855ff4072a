"""The port's training campaign against the reference's: data streams,
checkpoints, the trainer and the launch drivers.

* Streams: ``TokenStream`` and ``ClimateStream`` batches equal the
  reference's bit for bit for the same ``(seed, step)``.
* Checkpoints: either package restores what the other wrote, with its
  digest verified, for a ``glm4-9b`` smoke train state at O1 (fp32
  params) and O2 (bf16 params and moments).  The reference cannot read
  its own O2 checkpoint (a fault in the reference, ``ROADMAP.md`` §3).
* Training after a handover: the reference saves its ``init_state`` at
  step 0, the port's ``Trainer`` resumes from it, and both trainers take 4
  steps on the same stream at O0; losses within rtol 1e-5, the O0
  tolerance of ``test_torch_train.py``.
* The reference's trainer and checkpointer cases (``test_train.py``,
  ``test_resilience.py``), on the port (``granite-8b`` smoke, seq 32,
  batch 8, as there).
* Serving from a checkpoint the port's trainer wrote, and what the
  reference's ``launch/serve.py`` does with the same checkpoint.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.checkpoint import checkpointer as r_ckpt
from repro.configs import base as r_base
from repro.configs import deepcam as r_dc_cfg
from repro.configs.registry import get_smoke as r_get_smoke
from repro.data import pipeline as r_pipe
from repro.models import api as r_api
from repro.train import step as r_step
from repro.train.trainer import Trainer as RTrainer
from repro_torch.checkpoint import checkpointer as p_ckpt
from repro_torch.configs import base as p_base
from repro_torch.configs import deepcam as p_dc_cfg
from repro_torch.configs.registry import get_smoke as p_get_smoke
from repro_torch.data import pipeline as p_pipe
from repro_torch.launch import serve as p_serve
from repro_torch.launch import train as p_train
from repro_torch.models import api as p_api
from repro_torch.resilience import faults
from repro_torch.train import step as p_step
from repro_torch.train.trainer import Trainer

SHAPE = (32, 8)                      # granite-8b smoke: seq, batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small ops: the test run
    puts several workers on the host's cores, and a pool of as many
    threads as cores then waits at every op on threads that another
    worker holds (tens of times slower).  The checks hold at any thread
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
O0_RTOL = 1e-5                       # test_torch_train.py's O0 loss rtol
QUIET = dict(log_every=0, log=lambda *_: None)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


# --------------------------------------------------------------------------
# Streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["glm4-9b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2"])
def test_token_stream_equals_reference(arch):
    r_shape = r_base.ShapeSpec("t", 64, 2, "train")
    p_shape = p_base.ShapeSpec("t", 64, 2, "train")
    for seed, step in ((0, 0), (0, 7), (3, 1), (11, 250)):
        r = r_pipe.TokenStream(r_get_smoke(arch), r_shape, 2, seed)(step)
        p = p_pipe.TokenStream(p_get_smoke(arch), p_shape, 2, seed)(step)
        assert list(p) == list(r)
        for k in r:
            assert p[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(p[k], r[k])


def test_climate_stream_equals_reference():
    for hw, batch, seed, step in ((r_dc_cfg.SMOKE_HW, 2, 0, 0),
                                  (r_dc_cfg.SMOKE_HW, 2, 0, 5),
                                  ((40, 56), 3, 7, 2)):
        r = r_pipe.ClimateStream(hw, batch, seed=seed)(step)
        p = p_pipe.ClimateStream(hw, batch, seed=seed)(step)
        for k in ("images", "labels"):
            assert p[k].dtype == r[k].dtype
            np.testing.assert_array_equal(p[k], r[k])
    assert tuple(p_dc_cfg.SMOKE_HW) == tuple(r_dc_cfg.SMOKE_HW)
    assert tuple(p_dc_cfg.IMAGE_HW) == tuple(r_dc_cfg.IMAGE_HW)


def test_prefetcher_keeps_order_puts_on_device_and_closes():
    stream = p_pipe.ClimateStream((16, 24), 2)
    pf = p_pipe.Prefetcher(stream, start_step=5, prefetch=2,
                           transform=p_pipe.to_device("cpu"))
    try:
        for want in range(5, 12):
            step, batch = pf.next()
            assert step == want
            assert isinstance(batch["images"], torch.Tensor)
            np.testing.assert_array_equal(batch["labels"].numpy(),
                                          stream(want)["labels"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_surfaces_a_batch_error():
    def bad(step):
        if step == 2:
            raise ValueError("no batch 2")
        return step

    pf = p_pipe.Prefetcher(bad, prefetch=1)
    try:
        assert pf.next() == (0, 0) and pf.next() == (1, 1)
        with pytest.raises(ValueError, match="no batch 2"):
            pf.next()
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# --------------------------------------------------------------------------
# Checkpoints across the packages
# --------------------------------------------------------------------------

def _glm():
    return (r_api.build(r_get_smoke("glm4-9b")),
            p_api.build(p_get_smoke("glm4-9b")))


def _assert_same_state(port_state, ref_state):
    r = dict(r_ckpt._leaf_paths(ref_state))
    p = dict(p_ckpt._leaf_paths(port_state))
    assert sorted(p) == sorted(r)
    assert "params/embed/tokens" in p and "opt/mu/embed/tokens" in p
    assert "loss_scale/scale" in p and "opt/count" in p and "step" in p
    for name, leaf in r.items():
        got = p[name]
        assert str(got.dtype).removeprefix("torch.") == np.asarray(
            leaf).dtype.name, name
        assert tuple(got.shape) == tuple(np.shape(leaf)), name
        np.testing.assert_array_equal(_f32(got), _f32(leaf), err_msg=name)


@pytest.mark.parametrize("amp", ["O1", "O2"])
def test_port_checkpoint_restores_in_the_reference(amp, tmp_path):
    r_model, p_model = _glm()
    p_run = p_base.RunConfig(amp=amp)
    state = p_step.init_state(p_model, p_run,
                              torch.Generator().manual_seed(1), "cpu")
    # a non-zero moment, count and loss scale, so every leaf carries data
    g = torch.Generator().manual_seed(2)
    state.opt.mu["embed"]["tokens"].normal_(generator=g)
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    p_ckpt.save(str(tmp_path), 7, state, {"step": 7})
    like = jax.eval_shape(lambda: r_step.init_state(
        r_model, r_base.RunConfig(amp=amp), jax.random.PRNGKey(0)))
    restored, meta = r_ckpt.restore(str(tmp_path), like)     # verifies
    assert meta == {"step": 7}
    _assert_same_state(state, restored)
    if amp == "O2":
        assert restored.params["embed"]["tokens"].dtype == jnp.bfloat16


@pytest.mark.parametrize("amp", ["O1", "O2"])
def test_reference_checkpoint_restores_in_the_port(amp, tmp_path):
    r_model, p_model = _glm()
    r_run = r_base.RunConfig(amp=amp)
    state = r_step.init_state(r_model, r_run, jax.random.PRNGKey(0))
    r_ckpt.save(str(tmp_path), 3, state, {"step": 3})
    like = p_step.init_state(p_model, p_base.RunConfig(amp=amp), None,
                             "meta")
    restored, meta = p_ckpt.restore(str(tmp_path), like)     # verifies
    assert meta == {"step": 3}
    _assert_same_state(restored, jax.tree.map(np.asarray, state))
    assert restored.params["embed"]["tokens"].device.type == "cpu"
    # a corrupted manifest digest is caught
    mpath = tmp_path / "step_00000003" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["digest"] = "0" * 64
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(p_ckpt.CheckpointCorrupt):
        p_ckpt.restore(str(tmp_path), like)


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """A fault in the reference (``ROADMAP.md`` §3): ``np.savez`` stores an
    ``ml_dtypes.bfloat16`` leaf as ``'<V2'``, ``np.load`` gives it back as
    2-byte void, and ``restore`` hashes ``str(arr.dtype)`` — ``'|V2'``, not
    the ``'bfloat16'`` it hashed at save time
    (``src/repro/checkpoint/checkpointer.py:67-76,232-241``).  So every O2
    checkpoint fails its own digest, and the reference's trainer skips
    them all and starts again from its init.  The port reads the same
    checkpoint."""
    r_model, p_model = _glm()
    run = r_base.RunConfig(amp="O2")
    state = r_step.init_state(r_model, run, jax.random.PRNGKey(0))
    r_ckpt.save(str(tmp_path), 1, state)
    like = jax.eval_shape(lambda: r_step.init_state(
        r_model, run, jax.random.PRNGKey(0)))
    with pytest.raises(r_ckpt.CheckpointCorrupt):
        r_ckpt.restore(str(tmp_path), like)
    p_ckpt.restore(str(tmp_path), p_step.init_state(
        p_model, p_base.RunConfig(amp="O2"), None, "meta"))


def test_sub_tree_template_reads_only_its_leaves(tmp_path):
    tree = {"params": {"w": torch.ones(2, 3)},
            "opt": {"mu": {"w": torch.full((2, 3), 2.0)}}}
    p_ckpt.save(str(tmp_path), 1, tree)
    got, _ = p_ckpt.restore(str(tmp_path), {
        "params": {"w": torch.empty(2, 3, dtype=torch.bfloat16,
                                    device="meta")}})
    assert list(got) == ["params"]
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].float(), torch.ones(2, 3))
    with pytest.raises(KeyError):
        p_ckpt.restore(str(tmp_path), {"nope": torch.empty(1,
                                                           device="meta")})


# --------------------------------------------------------------------------
# Training after a handover: the reference's step-0 checkpoint, 4 steps
# --------------------------------------------------------------------------

def _handover(tmp_path, arch, r_stream, p_stream):
    run = r_base.RunConfig(amp="O0")
    r_model = r_api.build(r_get_smoke(arch))
    r_ckpt.save(str(tmp_path), 0, r_step.init_state(
        r_model, run, jax.random.PRNGKey(0)), {"step": 0})
    ref = RTrainer(r_model, run, r_stream).fit(4, **QUIET)
    port = Trainer(p_api.build(p_get_smoke(arch)),
                   p_base.RunConfig(amp="O0"), p_stream,
                   ckpt_dir=str(tmp_path), device="cpu")
    assert port.report.resumed_from == 0
    rep = port.fit(4, **QUIET)
    assert rep.steps == 4 and p_ckpt.latest_step(str(tmp_path)) == 4
    np.testing.assert_allclose(rep.losses, ref.losses, rtol=O0_RTOL)
    assert rep.losses[-1] < rep.losses[0]


def test_handover_glm4_token_stream(tmp_path):
    shape = (32, 4)
    _handover(tmp_path, "glm4-9b",
              r_pipe.TokenStream(r_get_smoke("glm4-9b"),
                                 r_base.ShapeSpec("t", *shape, "train"), 4),
              p_pipe.TokenStream(p_get_smoke("glm4-9b"),
                                 p_base.ShapeSpec("t", *shape, "train"), 4))


def test_handover_deepcam_climate_stream(tmp_path):
    _handover(tmp_path, "deepcam",
              r_pipe.ClimateStream(r_dc_cfg.SMOKE_HW, 2),
              p_pipe.ClimateStream(p_dc_cfg.SMOKE_HW, 2))


# --------------------------------------------------------------------------
# Deterministic algorithms: DeepCAM's resize backward as two products
# --------------------------------------------------------------------------

@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("shape,hw", [((2, 4, 6, 5), (16, 24)),
                                      ((1, 8, 12, 3), (16, 24)),
                                      ((2, 3, 5, 4), (7, 11)),
                                      ((1, 1, 1, 2), (4, 6))])
def test_deterministic_resize_matches_interpolate(shape, hw):
    """Under deterministic algorithms ``_resize`` keeps ``F.interpolate``'s
    forward and takes its backward from the interpolation matrices: the
    gradient equals ATen's (the host's is serial) within fp64 rounding,
    at DeepCAM's factors 4 and 2, a ragged factor and a 1×1 source."""
    from repro_torch.models import deepcam as p_dc
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g, dtype=torch.float64,
                    requires_grad=True)
    y = p_dc._resize(x, hw)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad(y, x, dy)[0]
    torch.use_deterministic_algorithms(True)
    try:
        y_det = p_dc._resize(x, hw)
        got = torch.autograd.grad(y_det, x, dy)[0]
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(y_det, y)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_deterministic_deepcam_gradients_match(deterministic):
    """The whole smoke DeepCAM's O0 gradients with the deterministic
    resize against the default path: within 1e-5 of each leaf's max
    (fp32 sums in another order)."""
    cfg = p_get_smoke("deepcam")
    model = p_api.build(cfg)
    run = p_base.RunConfig(amp="O0")
    params = p_step.init_state(model, run,
                               torch.Generator().manual_seed(0)).params
    batch = p_pipe.to_device("cpu")(p_pipe.ClimateStream(
        p_dc_cfg.SMOKE_HW, 2)(0))

    def grads():
        return p_step.value_and_grad(
            lambda p, b: model.loss_fn(p, b, run), params, batch)

    (loss_det, _), g_det = grads()
    torch.use_deterministic_algorithms(False)
    (loss, _), g = grads()
    torch.testing.assert_close(loss_det, loss, rtol=1e-6, atol=0)
    for a, b in zip(tree_flatten(g_det)[0], tree_flatten(g)[0]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max() + 1e-12


# --------------------------------------------------------------------------
# The reference's trainer and checkpointer cases, on the port
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    cfg = p_get_smoke("granite-8b")
    return cfg, p_api.build(cfg), p_base.ShapeSpec("t", *SHAPE, "train")


@pytest.fixture
def fault_env(monkeypatch):
    """Set REPRO_FAULTS for one test with fresh fire counters."""
    def set_plan(value: str) -> None:
        monkeypatch.setenv(faults.FAULT_ENV, value)
        faults._active = None
    yield set_plan
    faults._active = None


def _stream(granite):
    cfg, _, shape = granite
    return p_pipe.TokenStream(cfg, shape, batch=SHAPE[1])


def _trainer(granite, run=None, **kw):
    return Trainer(granite[1], run or p_base.RunConfig(amp="O1"),
                   kw.pop("stream", None) or _stream(granite), lr=1e-3,
                   device="cpu", **kw)


def _tiny_tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3)}


def test_roundtrip_and_latest(granite, tmp_path):
    _, model, _ = granite
    run = p_base.RunConfig()
    state = p_step.init_state(model, run, torch.Generator().manual_seed(0))
    d = str(tmp_path)
    p_ckpt.save(d, 3, state, {"step": 3})
    p_ckpt.save(d, 7, state, {"step": 7})
    assert p_ckpt.latest_step(d) == 7
    restored, meta = p_ckpt.restore(d, p_step.init_state(model, run, None,
                                                         "meta"))
    assert meta["step"] == 7
    a, b = tree_flatten(state.params)[0][0], tree_flatten(
        restored.params)[0][0]
    assert torch.equal(a, b)


def test_gc_keeps_three(granite, tmp_path):
    state = p_step.init_state(granite[1], p_base.RunConfig(),
                              torch.Generator().manual_seed(0))
    d = str(tmp_path)
    for s in range(5):
        p_ckpt.save(d, s, state)
    assert len([x for x in os.listdir(d) if x.startswith("step_")]) == 3
    assert p_ckpt.latest_step(d) == 4


def test_async_checkpointer(granite, tmp_path):
    run = p_base.RunConfig()
    state = p_step.init_state(granite[1], run,
                              torch.Generator().manual_seed(0))
    ac = p_ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path), 1, state, {"step": 1})
    # the snapshot is taken before save returns: an in-place update after
    # it does not reach the checkpoint
    before = state.params["embed"]["tokens"].clone()
    state.params["embed"]["tokens"].add_(1.0)
    ac.wait()
    assert [s for s, _ in ac.write_walls] == [1]
    restored, meta = p_ckpt.restore(str(tmp_path), p_step.init_state(
        granite[1], run, None, "meta"))
    assert meta["step"] == 1
    assert torch.equal(restored.params["embed"]["tokens"], before)


def test_dtype_cast_on_restore(tmp_path):
    p_ckpt.save(str(tmp_path), 0, {"w": torch.ones(4, 4)})
    out, _ = p_ckpt.restore(str(tmp_path), {
        "w": torch.empty(4, 4, dtype=torch.bfloat16, device="meta")})
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"


def test_restart_resumes_exactly(granite, tmp_path):
    d = str(tmp_path)
    _trainer(granite, ckpt_dir=d, ckpt_every=4).fit(8, **QUIET)
    t2 = _trainer(granite, ckpt_dir=d, ckpt_every=4)
    assert t2.report.resumed_from == 8
    assert int(t2.state.step) == 8
    rep = t2.fit(10, **QUIET)
    assert rep.steps == 2                  # only the remaining steps run


def test_resumed_run_repeats_the_uninterrupted_one(granite, tmp_path):
    """Resume is exact on the host: steps 8-9 of a run resumed at 8, fed
    by the prefetch thread, are the uninterrupted run's, bit for bit."""
    clean = _trainer(granite).fit(10, **QUIET)
    d = str(tmp_path)
    _trainer(granite, ckpt_dir=d, ckpt_every=4, prefetch=2).fit(8, **QUIET)
    rep = _trainer(granite, ckpt_dir=d, prefetch=2).fit(10, **QUIET)
    assert [x.hex() for x in rep.losses] == \
        [x.hex() for x in clean.losses[8:]]


def test_straggler_detection_fields(granite):
    cfg, model, shape = granite

    def stream(step):
        return p_api.synthetic_batch(cfg, shape, SHAPE[1],
                                     torch.Generator().manual_seed(step))

    t = Trainer(model, p_base.RunConfig(), stream, device="cpu",
                straggler_factor=1e-9)
    rep = t.fit(3, **QUIET)
    # with an absurd factor every post-warmup step is a "straggler"
    assert len(rep.stragglers) >= 1
    step_idx, dt, ewma = rep.stragglers[0]
    assert dt > 0 and ewma > 0


def test_digest_roundtrip(tmp_path):
    d = str(tmp_path)
    p_ckpt.save(d, 1, _tiny_tree())
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        assert len(json.load(f)["digest"]) == 64
    tree, _ = p_ckpt.restore(d, _tiny_tree())
    assert torch.equal(tree["w"], _tiny_tree()["w"])


def _edit_manifest(d, fn):
    mpath = os.path.join(d, "step_00000001", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    fn(manifest)
    with open(mpath, "w") as f:
        json.dump(manifest, f)


def test_digest_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    p_ckpt.save(d, 1, _tiny_tree())
    _edit_manifest(d, lambda m: m.update(digest="0" * 64))
    with pytest.raises(p_ckpt.CheckpointCorrupt):
        p_ckpt.restore(d, _tiny_tree())
    tree, _ = p_ckpt.restore(d, _tiny_tree(), verify=False)
    assert tree is not None                  # explicit opt-out works


def test_digestless_manifest_still_loads(tmp_path):
    d = str(tmp_path)
    p_ckpt.save(d, 1, _tiny_tree())
    _edit_manifest(d, lambda m: m.pop("digest"))
    tree, _ = p_ckpt.restore(d, _tiny_tree())
    assert torch.equal(tree["b"], torch.ones(3))


def test_gc_keep_parameter(tmp_path):
    d = str(tmp_path)
    for step in range(1, 6):
        p_ckpt.save(d, step, _tiny_tree(), keep=2)
    assert p_ckpt.available_steps(d) == [4, 5]
    d2 = str(tmp_path / "nogc")
    for step in range(1, 4):
        p_ckpt.save(d2, step, _tiny_tree(), keep=0)
    assert p_ckpt.available_steps(d2) == [1, 2, 3]


def test_gc_never_deletes_latest_target(tmp_path):
    d = str(tmp_path)
    for step in range(1, 5):
        p_ckpt.save(d, step, _tiny_tree(), keep=0)
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("step_00000001")
    p_ckpt._gc(d, keep=1)
    assert p_ckpt.available_steps(d) == [1, 4]  # pointed + newest


def test_async_healthy_surfaces_write_error(tmp_path, fault_env):
    fault_env("ckpt_fail:7")
    a = p_ckpt.AsyncCheckpointer()
    assert a.healthy()
    a.save(str(tmp_path), 7, _tiny_tree())
    deadline = time.monotonic() + 10
    while a.healthy() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not a.healthy()
    with pytest.raises(faults.InjectedFault):
        a.wait()
    assert a.healthy()                       # error surfaced once


def test_transient_retry_is_bit_identical(granite, fault_env):
    clean = _trainer(granite).fit(5, **QUIET)
    fault_env("step_fault:2x2")
    faulted = _trainer(granite, retry_backoff_s=0.0).fit(5, **QUIET)
    assert faulted.retries == 2
    assert [x.hex() for x in faulted.losses] == \
        [x.hex() for x in clean.losses]


def test_exhausted_retries_raise(granite, fault_env):
    fault_env("step_fault:1x-1")             # never stops firing
    t = _trainer(granite, step_retries=1, retry_backoff_s=0.0)
    with pytest.raises(faults.TransientFault):
        t.fit(3, **QUIET)
    assert t.report.steps == 1               # step 0 landed, 1 did not


def test_corrupt_newest_ckpt_falls_back(granite, tmp_path):
    d = str(tmp_path)
    first = _trainer(granite, ckpt_dir=d, ckpt_every=4)
    first_rep = first.fit(8, **QUIET)
    mpath = os.path.join(d, "step_00000008", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["digest"] = "f" * 64            # bit-rot the newest
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    t2 = _trainer(granite, ckpt_dir=d, ckpt_every=4)
    assert t2.report.resumed_from == 4       # older verified ckpt
    assert [s for s, _ in t2.report.skipped_ckpts] == [8]
    rep = t2.fit(8, **QUIET)                 # and repeats steps 4-7
    assert [x.hex() for x in rep.losses] == \
        [x.hex() for x in first_rep.losses[4:]]


def test_dead_ckpt_writer_fails_promptly(granite, tmp_path, fault_env):
    fault_env("ckpt_fail:2")
    t = _trainer(granite, ckpt_dir=str(tmp_path), ckpt_every=2)
    with pytest.raises(faults.InjectedFault):
        t.fit(12, log_every=1, log=lambda *_: None)
    assert t.report.steps < 12               # not at the very end


# --------------------------------------------------------------------------
# Launch drivers
# --------------------------------------------------------------------------

def test_launch_train_runs_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--arch", "deepcam", "--smoke", "--device", "cpu", "--ckpt", d,
            "--steps", "3", "--batch", "2", "--ckpt-every", "2"]
    assert p_train.main(argv) == 0
    assert "[train] 3 steps" in capsys.readouterr().out
    argv[argv.index("--steps") + 1] = "4"
    assert p_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] 1 steps" in out and "resumed_from=3" in out
    assert p_ckpt.latest_step(d) == 4
    assert p_train.build_parser().parse_args(
        ["--arch", "glm4-9b"]).device == "cuda"


@pytest.fixture(scope="module")
def trained_glm(tmp_path_factory):
    """A checkpoint of 2 steps of the port's trainer on glm4-9b smoke."""
    d = str(tmp_path_factory.mktemp("glm_ckpt"))
    t = p_train.make_trainer(p_get_smoke("glm4-9b"),
                             p_base.RunConfig(amp="O1"), smoke=True,
                             batch=4, seq=32, ckpt=d, device="cpu")
    t.fit(2, **QUIET)
    return d, t.state


def test_serve_restores_a_trainer_checkpoint(trained_glm, capsys):
    d, state = trained_glm
    like = p_api.build(p_get_smoke("glm4-9b"))
    from repro_torch.models.params import init
    params = p_serve.load_params(d, init(like.spec, None, torch.float32,
                                         "meta"), torch.device("cpu"))
    got, want = (dict(p_ckpt._leaf_paths(t)) for t in (params,
                                                       state.params))
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert p_serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                         "--ckpt", d, "--requests", "6"]) == 0
    out = capsys.readouterr().out
    assert "requests   6/6 completed" in out
    assert p_serve.build_parser().parse_args(
        ["--arch", "glm4-9b"]).device == "cuda"


def test_reference_serve_cannot_read_a_trainer_checkpoint(trained_glm):
    """A fault in the reference (``ROADMAP.md`` §3): ``launch/serve.py``
    restores ``--ckpt`` into a bare parameter tree
    (``src/repro/launch/serve.py:56-57``), whose leaf names (``embed``)
    are not a train state's (``params/embed``), so the checkpoint its own
    ``Trainer`` writes raises KeyError.  The checkpoint is the port's
    trainer's; the reference reads its leaves (above) but not this way."""
    from repro.launch import serve as r_serve
    d, _ = trained_glm
    with pytest.raises(KeyError):
        r_serve.main(["--arch", "glm4-9b", "--smoke", "--ckpt", d])
