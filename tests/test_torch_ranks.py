"""The port's sharded train step on eight gloo ranks on the host (the
reference's ``TestMiniDryRun``, run for real instead of compiled).

A spawned driver starts eight ranks of a gloo group on 127.0.0.1; each
runs the granite-8b smoke train step at O0 with the fused ops routed
(``fusion="static"``) on a (2, 4) ``("data", "model")`` mesh, every
leaf of the state and the batch a DTensor, and holds it against the
same step without a mesh: the loss and every parameter after one step,
gathered, at the port's O0 tolerance (``test_torch_train.py``: loss
rtol 1e-5, params atol 2e-5).  The fused ops must have run on DTensors
(through their sharding rules, on their plain versions on the host),
and a checkpoint saved on (2, 4) must restore with ``shardings=`` onto
a (4, 2) mesh with equal values.  The same ranks also run the trainer
on the mesh (a checkpoint and a resume), decode against a
sequence-sharded cache, the SSM, hybrid and MoE families, and each
kernel op's sharding rule.  The ranks have a timeout of their own; rank
0 writes the result as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

_DRIVER = textwrap.dedent('''
    import json, os, socket, sys, tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 8


    def worker(rank, port, out_path, ckpt_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=WORLD)
        try:
            _run(rank, out_path, ckpt_dir)
        finally:
            dist.destroy_process_group()


    def _run(rank, out_path, ckpt_dir):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.checkpoint import checkpointer as ckpt
        from repro_torch.configs.base import RunConfig, ShapeSpec
        from repro_torch.configs.registry import get_smoke
        from repro_torch.distributed import sharding as shd
        from repro_torch.models import api as M
        from repro_torch.train import step as TS

        cfg = get_smoke("granite-8b")
        run = RunConfig(amp="O0", fusion="static")
        model = M.build(cfg)
        gen = torch.Generator().manual_seed(0)
        state0 = TS.init_state(model, run, gen, "cpu")
        batch = M.synthetic_batch(cfg, ShapeSpec("t", 32, 8, "train"), 8,
                                  torch.Generator().manual_seed(1))
        step = TS.make_train_step(model, run)
        clone = lambda tree: torch.utils._pytree.tree_map(
            lambda t: t.clone(), tree)

        ref_state, ref_metrics = step(clone(state0), batch)

        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        specs = shd.named(TS.state_specs(model, run, mesh), mesh)
        state = shd.distribute(clone(state0), specs)
        dbatch = shd.distribute(batch, shd.named(
            shd.shard_batch_dim(batch, mesh, run), mesh))

        class OnDTensor(TorchDispatchMode):
            """The repro_torch:: ops called on DTensors."""
            seen = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "repro_torch" and any(
                        issubclass(t, DTensor) for t in types):
                    name = func._opname
                    self.seen[name] = self.seen.get(name, 0) + 1
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                return func(*args, **(kwargs or {}))

        with OnDTensor() as mode:
            new_state, metrics = step(state, dbatch)
        loss = float(shd.gather(metrics["loss"]))
        got = shd.gather(new_state.params)
        flat_got = torch.utils._pytree.tree_flatten(got)[0]
        flat_ref = torch.utils._pytree.tree_flatten(ref_state.params)[0]
        param_err = max(float((a - b).abs().max())
                        for a, b in zip(flat_got, flat_ref))
        placed = sum(1 for t in torch.utils._pytree.tree_flatten(
            new_state.params)[0] if isinstance(t, DTensor))

        # elastic re-mesh: saved on (2, 4), restored onto (4, 2)
        ckpt.save(ckpt_dir, 1, new_state)
        mesh2 = init_device_mesh("cpu", (4, 2),
                                 mesh_dim_names=("data", "model"))
        like = TS.init_state(model, run, None, "meta")
        specs2 = shd.named(TS.state_specs(model, run, mesh2, like), mesh2)
        restored, _ = ckpt.restore(ckpt_dir, like, shardings=specs2)
        flat_a = torch.utils._pytree.tree_flatten(shd.gather(new_state))[0]
        flat_b = torch.utils._pytree.tree_flatten(shd.gather(restored))[0]
        elastic = all(torch.equal(a, b) for a, b in zip(flat_a, flat_b))
        leaf = torch.utils._pytree.tree_flatten(restored.params)[0][0]

        # the trainer on the mesh: two steps, its checkpoint (gathered,
        # rank 0 writes), a second trainer restoring it onto the mesh
        from repro_torch.data.pipeline import TokenStream
        from repro_torch.train.trainer import Trainer
        stream = TokenStream(cfg, ShapeSpec("t", 32, 8, "train"), 8, seed=0)
        tdir = os.path.join(ckpt_dir, "trainer")
        t1 = Trainer(model, run, stream, ckpt_dir=tdir, ckpt_every=0,
                     device="cpu", mesh=mesh)
        rep1 = t1.fit(2, log_every=0)
        t2 = Trainer(model, run, stream, ckpt_dir=tdir, ckpt_every=0,
                     device="cpu", mesh=mesh)
        ta = torch.utils._pytree.tree_flatten(shd.gather(t1.state))[0]
        tb = torch.utils._pytree.tree_flatten(shd.gather(t2.state))[0]
        trainer = {
            "losses": rep1.losses, "resumed_from": t2.report.resumed_from,
            "equal": len(ta) == len(tb) and all(torch.equal(a, b)
                                                for a, b in zip(ta, tb)),
            "placed": all(isinstance(t, DTensor) for t in
                          torch.utils._pytree.tree_flatten(t2.state)[0]),
        }
        plain = Trainer(model, run, stream, device="cpu").fit(2, log_every=0)
        trainer["plain_losses"] = plain.losses

        # decode against a cache sharded on its sequence (granite's one
        # KV head does not divide the model axis): an aligned fill and a
        # per-row one, against the same step without a mesh
        gen2 = torch.Generator().manual_seed(2)
        params = shd.gather(new_state.params)
        decode = {}
        for kind, fill in (("aligned", torch.tensor(5, dtype=torch.int32)),
                           ("rows", torch.tensor([0, 3, 7, 63, 64, 9, 1, 30],
                                                 dtype=torch.int32))):
            st = model.init_state_fn(8, 64, torch.float32, "cpu")
            st = st._replace(
                k=torch.randn(st.k.shape, generator=gen2),
                v=torch.randn(st.v.shape, generator=gen2), length=fill)
            tok = {"tokens": torch.randint(0, cfg.vocab_size, (8, 1),
                                           generator=gen2, dtype=torch.int32)}
            want, want_st = model.decode_fn(params, tok, clone(st), run)
            dp = shd.distribute(params, shd.named(
                shd.param_shardings(model.spec, mesh, run), mesh))
            spec = shd.decode_state_shardings(st, mesh, run)
            dst = shd.distribute(clone(st), shd.named(spec, mesh))
            dtok = shd.distribute(tok, shd.named(
                shd.shard_batch_dim(tok, mesh, run), mesh))
            got, got_st = model.decode_fn(dp, dtok, dst, run)
            decode[kind] = {
                "spec_k": list(map(str, spec.k)),
                "logits_err": float((shd.gather(got) - want).abs().max()),
                "k_err": float((shd.gather(got_st.k) - want_st.k).abs().max()),
                "v_err": float((shd.gather(got_st.v) - want_st.v).abs().max()),
            }
        # the other families' forwards on the mesh: the SSM (its conv's
        # zero rows), the hybrid, the MoE (local routing, the experts'
        # partial sums) and its aux loss
        families = {}
        for arch in ("mamba2-1.3b", "zamba2-1.2b", "granite-moe-1b-a400m"):
            fcfg = get_smoke(arch)
            fmodel = M.build(fcfg)
            frun = RunConfig(amp="O0")
            fparams = TS.init_state(fmodel, frun, torch.Generator()
                                    .manual_seed(4), "cpu").params
            fbatch = M.synthetic_batch(fcfg, ShapeSpec("t", 32, 8, "train"),
                                       8, torch.Generator().manual_seed(5))
            want, want_m = fmodel.loss_fn(fparams, fbatch, frun)
            want_logits = fmodel.forward_fn(fparams, fbatch, frun)
            dparams = shd.distribute(fparams, shd.named(
                shd.param_shardings(fmodel.spec, mesh, frun), mesh))
            dfb = shd.distribute(fbatch, shd.named(
                shd.shard_batch_dim(fbatch, mesh, frun), mesh))
            got, got_m = fmodel.loss_fn(dparams, dfb, frun)
            got_logits = fmodel.forward_fn(dparams, dfb, frun)
            # one decode step from a random state (the SSM's recurrence;
            # the hybrid's window)
            dec_err = 0.0
            if arch != "granite-moe-1b-a400m":
                st = fmodel.init_state_fn(8, 64, torch.float32, "cpu")
                st = torch.utils._pytree.tree_map(
                    lambda t: torch.randn(t.shape, generator=gen2).to(t.dtype)
                    if t.is_floating_point() else t, st)
                tok = {"tokens": fbatch["tokens"][:, :1]}
                want_d, want_st = fmodel.decode_fn(fparams, tok, clone(st),
                                                   frun)
                dst = shd.distribute(clone(st), shd.named(
                    shd.decode_state_shardings(st, mesh, frun), mesh))
                dtok = shd.distribute(tok, shd.named(
                    shd.shard_batch_dim(tok, mesh, frun), mesh))
                got_d, got_st = fmodel.decode_fn(dparams, dtok, dst, frun)
                dec_err = max(
                    [float((shd.gather(got_d) - want_d).abs().max())]
                    + [float((a.float() - b.float()).abs().max())
                       for a, b in zip(
                           torch.utils._pytree.tree_flatten(
                               shd.gather(got_st))[0],
                           torch.utils._pytree.tree_flatten(want_st)[0])])
            families[arch] = {
                "decode_err": dec_err,
                "loss_err": abs(float(shd.gather(got)) - float(want)),
                "logits_err": float((shd.gather(got_logits)
                                     - want_logits).abs().max()),
                "aux_err": abs(float(shd.gather(got_m["aux"]))
                               - float(want_m["aux"]))
                if "aux" in want_m else 0.0,
            }

        # each kernel op called on DTensors under each placement its rule
        # shards (and one it must redistribute first), against the op on
        # the whole tensors: the same plain version on every shard
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        ops = torch.ops.repro_torch
        g3 = torch.Generator().manual_seed(3)
        rnd = lambda *shape: torch.randn(shape, generator=g3)
        mesh1 = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
        put = lambda t, pl: distribute_tensor(t, mesh1, [pl],
                                              src_data_rank=None)
        x, sc, bi = rnd(16, 24), rnd(24), rnd(24)
        q, k, v = rnd(8, 16, 2, 4, 8), rnd(8, 16, 2, 8), rnd(8, 16, 2, 8)
        xh, la = rnd(8, 16, 8, 4), -rnd(8, 16, 8).abs()
        bm, cm = rnd(8, 16, 6), rnd(8, 16, 6)
        R, S0 = Replicate(), Shard(0)
        cases = {
            "layernorm rows": (ops.layernorm, (x, sc, bi, 1e-5, torch.float32),
                               (S0, R, R)),
            "layernorm cols": (ops.layernorm, (x, sc, bi, 1e-5, torch.float32),
                               (Shard(1), R, R)),
            "rmsnorm rows": (ops.rmsnorm, (x, sc, 1e-5, torch.float32),
                             (S0, R)),
            "swiglu cols": (ops.swiglu, (x, rnd(16, 24), "silu",
                                         torch.float32), (Shard(1),) * 2),
            "flash batch": (ops.flash_attention, (q, k, v, True), (S0,) * 3),
            "flash groups": (ops.flash_attention, (q, k, v, True),
                             (Shard(3), R, R)),
            "ssd batch": (ops.ssd_scan, (xh, la, bm, cm, 8), (S0,) * 4),
            "ssd heads": (ops.ssd_scan, (xh, la, bm, cm, 8),
                          (Shard(2), Shard(2), R, R)),
        }
        rules = {}
        for name, (op, args, pls) in cases.items():
            want = op(*args)
            tens = [a for a in args if isinstance(a, torch.Tensor)]
            dargs = list(args)
            for i, (t, pl) in enumerate(zip(tens, pls)):
                dargs[i] = put(t, pl)
            got = op(*dargs)
            # flash attention returns (o, lse): both held, o's placement
            wants = want if isinstance(want, tuple) else (want,)
            gots = got if isinstance(got, tuple) else (got,)
            rules[name] = {"err": max(float((g_.full_tensor() - w).abs().max())
                                      for g_, w in zip(gots, wants)),
                           "placement": repr(gots[0].placements[0])}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({
                    "loss": loss, "ref_loss": float(ref_metrics["loss"]),
                    "param_err": param_err, "n_params": len(flat_ref),
                    "placed": placed, "on_dtensor": mode.seen,
                    "elastic": elastic,
                    "mesh2": list(leaf.device_mesh.shape),
                    "mesh2_names": list(leaf.device_mesh.mesh_dim_names),
                    "decode": decode, "rules": rules,
                    "families": families, "trainer": trainer,
                }, f)


    if __name__ == "__main__":
        out_path, ckpt_dir = sys.argv[1], sys.argv[2]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.start_processes(worker, args=(port, out_path, ckpt_dir),
                           nprocs=WORLD, start_method="spawn")
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    script = tmp / "ranks.py"
    script.write_text(_DRIVER)
    out = tmp / "result.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), str(out), str(tmp / "ckpt")],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_sharded_granite_step_on_eight_gloo_ranks(ranks):
    rec = ranks
    assert rec["loss"] == pytest.approx(rec["ref_loss"], rel=1e-5)
    assert rec["param_err"] <= 2e-5
    assert rec["placed"] == rec["n_params"]          # every leaf a DTensor
    # the fused ops ran on DTensors, through their sharding rules
    for op in ("rmsnorm", "rmsnorm_residual", "swiglu"):
        assert rec["on_dtensor"].get(op, 0) > 0, rec["on_dtensor"]
    assert rec["elastic"]
    assert rec["mesh2"] == [4, 2]
    assert rec["mesh2_names"] == ["data", "model"]



def test_sequence_sharded_decode_equals_the_plain_step(ranks):
    """A decode step against a cache sharded on its sequence (granite's
    one KV head does not divide the 4-way model axis): flash decoding
    across the shards, the new token written into the shard that holds
    its position, at an aligned fill and a per-row one (a row past the
    cache's end is dropped); logits and the new caches within 1e-5 (O0).
    """
    for kind, d in ranks["decode"].items():
        assert d["spec_k"] == ["None", "data", "model"], kind
        assert d["logits_err"] <= 1e-5, kind
        # the new row's k / v are a row-parallel product's partial sums,
        # added in another order: fp32 rounding
        assert d["k_err"] <= 1e-5 and d["v_err"] <= 1e-5, kind


def test_kernel_op_rules_run_the_plain_version_on_each_shard(ranks):
    """The sharding rules of the kernel ops (``kernels.sharding_rules``):
    each op on DTensors equals the op on the whole tensors, sharded where
    its math is independent (rows, batch, KV-head groups, SSD heads) and
    redistributed first where it is not (a norm's columns)."""
    rules = ranks["rules"]
    for name, r in rules.items():
        assert r["err"] <= 1e-5, (name, r)
    assert rules["layernorm rows"]["placement"] == "Shard(dim=0)"
    assert rules["layernorm cols"]["placement"] in ("Shard(dim=0)",
                                                    "Replicate()")
    assert rules["swiglu cols"]["placement"] == "Shard(dim=1)"
    # DTensor picks the cheapest acceptable strategy: the inputs' own
    # shard, or the batch's
    assert rules["flash groups"]["placement"] in ("Shard(dim=3)",
                                                  "Shard(dim=0)")
    assert rules["ssd heads"]["placement"] in ("Shard(dim=2)",
                                               "Shard(dim=0)")


def test_other_families_forward_on_the_mesh(ranks):
    """mamba2 (the SSM's conv on a mesh), zamba2 (the hybrid) and
    granite-moe (the MoE's local routing and expert-parallel combine,
    with its aux loss) at the smoke size on (2, 4), O0: logits, loss and
    aux against the same forward without a mesh; mamba2's and zamba2's
    decode step from a random state (logits and new state)."""
    fam = ranks["families"]
    assert sorted(fam) == ["granite-moe-1b-a400m", "mamba2-1.3b",
                           "zamba2-1.2b"]
    for arch, r in fam.items():
        assert r["logits_err"] <= 1e-4 and r["decode_err"] <= 1e-4, (arch, r)
        assert r["loss_err"] <= 1e-5 and r["aux_err"] <= 1e-5, (arch, r)


def test_trainer_on_the_mesh_restores_its_checkpoint(ranks):
    """``Trainer(mesh=)``: two steps on the (2, 4) mesh at the plain
    trainer's losses (O0 rtol 1e-5), a checkpoint gathered and written
    by rank 0, and a second trainer on the mesh resuming from it with
    every leaf a DTensor, bit for bit."""
    t = ranks["trainer"]
    assert t["resumed_from"] == 2 and t["equal"] and t["placed"]
    assert t["losses"] == pytest.approx(t["plain_losses"], rel=1e-5)
