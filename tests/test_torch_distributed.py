"""The port's gradient compression and GPipe schedule
(``repro_torch.distributed.compression`` / ``pipeline``) held against
the reference's on the host.

``compress`` / ``decompress`` / ``compress_with_feedback`` equal the
reference's on seeded inputs (the int8 payload exactly, the scale and
the residual within 1e-7 relative).  A spawned driver starts 8 gloo
ranks on 127.0.0.1 once (each with a process-group timeout; rank 0
writes the gathered results): ``psum_compressed`` on each rank against the mean over
ranks of the reference's ``decompress(compress_with_feedback(g_r,
r_r))`` within 1e-6, and ``gpipe`` with L = 8, M = 4, b = 2, s = 4,
d = 16 (the reference's own test's sizes) against the reference's plain
stacked loop within 1e-4, its gradient against ``jax.grad`` of that
loop within 1e-4.  The reference's 8-device ``shard_map`` test does not
run on this jax, so the port is held against its pure functions and its
oracle loop.  The op walk counts the int8 all-gather of
``psum_compressed`` as the reference's HLO walk counts an all-gather.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as R_CMP
from repro.distributed import pipeline as R_PIPE
from repro_torch.distributed import compression as CMP
from repro_torch.distributed import pipeline as PIPE

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 8
#: gpipe's sizes: the reference's own test's (tests/test_distributed.py)
L, M, B, S, D = 8, 4, 2, 4, 16


def _inputs(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape,seed,scale", [
    ((64,), 0, 1.0), ((16, 33), 1, 1e-3), ((4, 8, 8), 2, 50.0),
    ((1,), 3, 0.3), ((128, 128), 4, 1.0)])
def test_compress_equals_reference(shape, seed, scale):
    g = _inputs(shape, seed, scale)
    r = _inputs(shape, seed + 100, scale * 1e-2)
    q, s = CMP.compress(torch.from_numpy(g))
    rq, rs = R_CMP.compress(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
    np.testing.assert_allclose(CMP.decompress(q, s).numpy(),
                               np.asarray(R_CMP.decompress(rq, rs)),
                               rtol=1e-7)
    q, s, nr = CMP.compress_with_feedback(torch.from_numpy(g),
                                          torch.from_numpy(r))
    rq, rs, rnr = R_CMP.compress_with_feedback(jnp.asarray(g),
                                               jnp.asarray(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
    np.testing.assert_allclose(nr.numpy(), np.asarray(rnr), rtol=1e-7,
                               atol=1e-7 * float(np.abs(np.asarray(rnr))
                                                 .max()))


def test_compress_of_zeros_has_unit_scale():
    q, s = CMP.compress(torch.zeros(5))
    rq, rs = R_CMP.compress(jnp.zeros(5))
    assert float(s) == float(rs) == 1.0
    assert not q.any() and not np.asarray(rq).any()


class TestCompressionLocal:
    """The reference's ``TestCompressionLocal`` over the port."""

    def test_roundtrip(self):
        g = torch.tensor([0.5, -1.25, 3.0])
        q, s = CMP.compress(g)
        assert q.dtype == torch.int8
        np.testing.assert_allclose(CMP.decompress(q, s).numpy(), g.numpy(),
                                   atol=float(s) / 2 + 1e-6)

    def test_error_feedback_init(self):
        ef = CMP.ErrorFeedback.init({"w": torch.ones(2, 3)})
        assert ef.residual["w"].shape == (2, 3)
        assert ef.residual["w"].dtype == torch.float32
        assert float(ef.residual["w"].abs().sum()) == 0.0

    def test_feedback_captures_residual(self):
        g = torch.tensor([0.3])
        q, s, r = CMP.compress_with_feedback(g, torch.zeros(1))
        np.testing.assert_allclose((CMP.decompress(q, s) + r).numpy(),
                                   g.numpy(), rtol=1e-6)


@pytest.mark.parametrize("stages,micro", [(1, 8), (2, 1), (4, 12), (8, 4),
                                          (3, 7), (16, 64)])
def test_bubble_fraction_equals_reference(stages, micro):
    assert PIPE.bubble_fraction(stages, micro) == \
        R_PIPE.bubble_fraction(stages, micro)
    assert PIPE.bubble_fraction(4, 12) == 3 / 15
    assert PIPE.bubble_fraction(1, 8) == 0.0


# --------------------------------------------------------------------------
# The op walk counts the compressed exchange
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 8])
def test_walk_counts_the_int8_all_gather(n):
    """``psum_compressed`` under the op walk, on a fake group of ``n``
    ranks: one int8 all-gather of the payload (and one of the scales),
    wire bytes as the reference's HLO walk counts an all-gather
    (``(n-1)/n`` of its ``n·N``-byte output), against an fp32 ring
    all-reduce's ``2(n-1)/n · 4N``: a quarter of it on the reference's
    two-pod axis (n = 2, its ``TestCompressedWireBytes``), ``n/8`` in
    general."""
    import torch.distributed as dist

    from repro.core.hlo_analysis import _COLL_MULT as R_MULT
    from repro_torch.core.op_analysis import analyze_fn
    from repro_torch.launch.mesh import fake_group, release_fake_group

    N = 4096
    fake_group(n)
    try:
        group = dist.group.WORLD
        comp = analyze_fn(lambda g, r: CMP.psum_compressed(g, r, group),
                          (torch.empty(N), torch.empty(N)))

        def fp32_all_reduce(g):
            ops = torch.ops._c10d_functional
            return ops.wait_tensor(ops.all_reduce(g, "sum",
                                                  group.group_name))
        full = analyze_fn(fp32_all_reduce, (torch.empty(N),))
    finally:
        release_fake_group()
    gathers = sorted(comp.collectives, key=lambda c: -c.payload_bytes)
    assert [c.opcode for c in gathers] == ["all-gather", "all-gather"]
    q = gathers[0]
    assert (q.group_size, q.payload_bytes) == (n, n * N)      # int8: 1 B
    assert q.wire_bytes == pytest.approx(R_MULT["all-gather"](n) * n * N)
    assert gathers[1].payload_bytes == n * 4                  # the scales
    (ar,) = full.collectives
    assert ar.opcode == "all-reduce"
    assert ar.wire_bytes == pytest.approx(2 * (n - 1) / n * 4 * N)
    assert q.wire_bytes / ar.wire_bytes == pytest.approx(n / 8)


# --------------------------------------------------------------------------
# 8 gloo ranks: the compressed mean and the pipeline
# --------------------------------------------------------------------------

_DRIVER = textwrap.dedent('''
    import datetime, socket, sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 8
    L, M, B, S, D = 8, 4, 2, 4, 16


    def worker(rank, port, inputs, out_path):
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=WORLD, timeout=datetime.timedelta(seconds=240))
        try:
            _run(rank, inputs, out_path)
        finally:
            dist.destroy_process_group()


    def _run(rank, inputs, out_path):
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.distributed import compression as CMP
        from repro_torch.distributed.pipeline import gpipe, stage_slice

        d = np.load(inputs)
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pod",))
        g = torch.from_numpy(d["g"][rank])
        r = torch.from_numpy(d["r"][rank])
        mean, res = CMP.psum_compressed(g, r, mesh)
        tree = {"a": g, "b": [torch.from_numpy(d["g2"][rank])]}
        ef = CMP.ErrorFeedback.init(tree)
        tmean, tef = CMP.tree_psum_compressed(tree, ef, mesh)

        ws = torch.from_numpy(d["ws"])
        first, per = stage_slice(L, mesh)
        local = ws[first:first + per].clone().requires_grad_(True)

        def stage_fn(w, x):
            for i in range(w.shape[0]):
                x = torch.tanh(x @ w[i])
            return x
        out = gpipe(stage_fn, local, torch.from_numpy(d["xs"]), mesh)
        out.square().sum().backward()

        def gather(t):
            buf = [torch.empty_like(t) for _ in range(WORLD)]
            dist.all_gather(buf, t.contiguous())
            return torch.stack(buf).numpy()
        got = {"mean": gather(mean), "res": gather(res),
               "tmean_a": gather(tmean["a"]), "tmean_b": gather(tmean["b"][0]),
               "tres_a": gather(tef.residual["a"]),
               "out": gather(out.detach()), "grad": gather(local.grad),
               "slice": gather(torch.tensor([first, per]))}
        if rank == 0:
            np.savez(out_path, **got)


    if __name__ == "__main__":
        inputs, out_path = sys.argv[1], sys.argv[2]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.spawn(worker, args=(port, inputs, out_path), nprocs=WORLD)
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(7)
    inputs = {
        "g": rng.standard_normal((WORLD, 64, 33)).astype(np.float32),
        "r": (rng.standard_normal((WORLD, 64, 33)) * 1e-2).astype(
            np.float32),
        "g2": rng.standard_normal((WORLD, 5)).astype(np.float32),
        "ws": (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32),
        "xs": rng.standard_normal((M, B, S, D)).astype(np.float32),
    }
    np.savez(d / "in.npz", **inputs)
    script = d / "driver.py"
    script.write_text(_DRIVER)
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(script), str(d / "in.npz"),
                           str(d / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inputs, dict(np.load(d / "out.npz"))


def _ref_compressed_mean(gs, rs):
    """The reference's math composed over ranks: the mean of each rank's
    ``decompress(compress_with_feedback(g_r, r_r))``, and each rank's
    residual."""
    outs = [R_CMP.compress_with_feedback(jnp.asarray(g), jnp.asarray(r))
            for g, r in zip(gs, rs)]
    mean = np.mean([np.asarray(R_CMP.decompress(q, s)) for q, s, _ in outs],
                   axis=0)
    return mean, np.stack([np.asarray(nr) for _, _, nr in outs])


def test_psum_compressed_on_eight_ranks_equals_the_reference(ranks):
    inputs, got = ranks
    mean, res = _ref_compressed_mean(inputs["g"], inputs["r"])
    for rank in range(WORLD):
        np.testing.assert_allclose(got["mean"][rank], mean, rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(got["res"], res, rtol=0, atol=1e-6)
    # and the compressed mean is within one quantum of the exact one
    exact = (inputs["g"] + inputs["r"]).mean(0)
    quantum = np.abs(inputs["g"] + inputs["r"]).max() / 127
    assert np.abs(got["mean"][0] - exact).max() <= quantum


def test_tree_psum_compressed_on_eight_ranks(ranks):
    inputs, got = ranks
    zeros = np.zeros_like(inputs["g"])
    mean_a, res_a = _ref_compressed_mean(inputs["g"], zeros)
    mean_b, _ = _ref_compressed_mean(inputs["g2"], np.zeros_like(
        inputs["g2"]))
    np.testing.assert_allclose(got["tmean_a"][0], mean_a, atol=1e-6)
    np.testing.assert_allclose(got["tmean_b"][0], mean_b, atol=1e-6)
    np.testing.assert_allclose(got["tres_a"], res_a, atol=1e-6)


def _reference_loop(ws, xs):
    """The reference test's oracle: the stacked layers applied in turn."""
    out = xs
    for i in range(L):
        out = jnp.tanh(out @ ws[i])
    return out


def test_gpipe_on_eight_ranks_equals_the_plain_loop(ranks):
    inputs, got = ranks
    ref = np.asarray(_reference_loop(jnp.asarray(inputs["ws"]),
                                     jnp.asarray(inputs["xs"])))
    assert np.abs(got["out"][WORLD - 1] - ref).max() < 1e-4
    # the other stages commit nothing
    assert not got["out"][:WORLD - 1].any()
    assert got["slice"].tolist() == [[r, 1] for r in range(WORLD)]


def test_gpipe_gradient_equals_the_loops(ranks):
    inputs, got = ranks
    g = jax.grad(lambda w: jnp.sum(jnp.square(_reference_loop(
        w, jnp.asarray(inputs["xs"])))))(jnp.asarray(inputs["ws"]))
    assert np.abs(got["grad"][:, 0] - np.asarray(g)).max() < 1e-4
