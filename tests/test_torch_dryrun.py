"""The port's per-device op walk, the dry run and the suites on it.

The walks on a mesh run in one spawned process (a fake process group
of 8 ranks, made and destroyed there, so no default group leaks into
later tests of this worker); it prints one JSON document that the tests
below read:

* on a (2, 4) ``("data", "model")`` mesh each product's per-device FLOPs
  are the unsharded walk's FLOPs for that product divided by the mesh
  axes that shard it — a replicated product counts whole — exactly;
  the row-parallel product's partial sum is one all-reduce whose wire
  bytes follow the ring rule, and ``roofline_terms`` reads a nonzero
  collective term;
* on a (2, 2, 2) ``("pod", "data", "model")`` mesh with 4 devices a pod,
  a reduction over each axis is flagged ``cross_pod`` only over ``pod``
  (the reference's rule: a group's ranks in more than one pod);
* ``run_cell`` of the glm4-9b smoke train step on (2, 4) writes every
  key of the reference's record, and the walk that folds its two
  microbatches into one equals the walk of both, op for op.

The suites run in the test process: ``roofline_table`` over a written
dry-run file and without one, ``decode_batch_study --smoke`` (glm4-9b at
full size, its two batches) in a spawned process with its own workspace.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

#: the reference's record keys (``repro.launch.dryrun.run_cell``) less its
#: ``adj_*`` fields, which the port leaves out
REFERENCE_KEYS = (
    "arch", "shape", "mesh", "n_devices", "run", "compile_s", "compute_s",
    "memory_s", "collective_ici_s", "collective_dcn_s", "dominant",
    "bound_overlap_s", "roofline_fraction", "hlo_flops_per_dev",
    "flops_by_class", "hbm_bytes_per_dev", "ici_wire_bytes",
    "dcn_wire_bytes", "model_flops_global", "model_flops_ratio",
    "peak_device_bytes", "fits_hbm", "memory", "xla_flops", "xla_bytes",
    "n_kernels", "zero_ai")

_WALKS = textwrap.dedent('''
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core.machine import H100_SXM
    from repro_torch.core.op_analysis import analyze_fn
    from repro_torch.core.roofline import roofline_terms
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, release_fake_group

    out = {}
    B, D, F = 16, 64, 128

    def mlp(x, w1, w2, w3):
        h = x @ w1            # column parallel: w1 sharded on F
        y = h @ w2            # row parallel: a partial sum over "model"
        z = x @ w3            # w3 replicated: every rank runs it whole
        return y.redistribute(y.device_mesh, [Shard(0), Replicate()]) \\
            if hasattr(y, "redistribute") else y, z

    def tensors(mesh=None):
        shapes = {"x": (B, D), "w1": (D, F), "w2": (F, D), "w3": (D, D)}
        pls = {"x": [Shard(0), Replicate()], "w1": [Replicate(), Shard(1)],
               "w2": [Replicate(), Shard(0)], "w3": [Replicate(), Replicate()]}
        out = []
        for k in ("x", "w1", "w2", "w3"):
            t = torch.empty(shapes[k], device="meta")
            out.append(t if mesh is None else distribute_tensor(
                t, mesh, pls[k], src_data_rank=None))
        return out

    plain = analyze_fn(mlp, tensors())
    mesh = make_mesh((2, 4), ("data", "model"))
    sharded = analyze_fn(mlp, tensors(mesh), devices_per_pod=8)
    mm = lambda an: [(k.op_name, k.total_flops) for k in an.kernels
                     if k.category == "matmul"]
    out["plain_mm"] = mm(plain)
    out["mesh_mm"] = mm(sharded)
    out["collectives"] = [dict(opcode=c.opcode, n=c.group_size,
                               payload=c.payload_bytes, wire=c.wire_bytes,
                               cross=c.cross_pod, count=c.exec_count)
                          for c in sharded.collectives]
    terms = roofline_terms(sharded, H100_SXM)
    out["collective_s"] = terms.collective_s
    out["ici_wire"] = terms.ici_wire_bytes

    # cross-pod flags on a (2, 2, 2) mesh, 4 devices a pod
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))

    def reduce_each(a, b, c):
        return [t.redistribute(t.device_mesh, [Replicate()] * 3)
                for t in (a, b, c)]

    parts = []
    for axis in range(3):
        pl = [Replicate()] * 3
        pl[axis] = Partial()
        local = torch.empty((8, 8), device="meta")
        from torch.distributed.tensor import DTensor
        parts.append(DTensor.from_local(local, mesh3, pl, run_check=False))
    an3 = analyze_fn(reduce_each, parts, devices_per_pod=4)
    out["cross"] = sorted((c.group_size, c.cross_pod, c.opcode)
                          for c in an3.collectives)
    out["cross_ranks"] = {str(a): dist.get_process_group_ranks(
        mesh3.get_group(a)) for a in range(3)}

    # the smoke train step's cell on (2, 4): record keys, folded walk
    cfg = get_smoke("glm4-9b")
    shape = ShapeSpec("t", 32, 8, "train")
    over = dict(microbatches=2, amp="O0")
    rec = dryrun.run_cell("glm4-9b", shape, "single", mesh=mesh, cfg=cfg,
                          run_overrides=over)
    out["record"] = rec
    _, folded = dryrun.run_cell("glm4-9b", shape, "single", mesh=mesh,
                                cfg=cfg, run_overrides=over,
                                return_profile=True)
    _, full = dryrun.run_cell("glm4-9b", shape, "single", mesh=mesh,
                              cfg=cfg, run_overrides=over,
                              return_profile=True, fold_loops=False)
    table = lambda an: sorted((k.opcode, k.op_name, k.exec_count,
                               k.total_flops, k.total_hbm_bytes)
                              for k in an.kernels)
    coll = lambda an: sorted((c.opcode, c.group_size, c.exec_count,
                              c.total_wire_bytes) for c in an.collectives)
    out["folded_equal"] = table(folded.analysis) == table(full.analysis)
    out["folded_coll_equal"] = coll(folded.analysis) == coll(full.analysis)
    out["folded_flops"] = [folded.analysis.total_flops,
                           full.analysis.total_flops]
    release_fake_group()
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def walks():
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _WALKS], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_per_device_flops_are_the_sharded_share_exactly(walks):
    plain = [f for _, f in walks["plain_mm"]]
    mesh = [f for _, f in walks["mesh_mm"]]
    assert len(plain) == len(mesh) == 3
    # x@w1: batch over data (2), F over model (4); h@w2: the same two
    # axes (the contraction's F shard over model); x@w3: batch only
    assert mesh[0] == plain[0] / (2 * 4)
    assert mesh[1] == plain[1] / (2 * 4)
    assert mesh[2] == plain[2] / 2


def test_replicated_product_counts_whole():
    from repro_torch.core.op_analysis import analyze_fn
    import torch
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 4, device="meta")
    an = analyze_fn(lambda x, y: x @ y, (a, b))
    assert an.total_flops == 2 * 8 * 16 * 4 and not an.collectives


def test_all_reduce_wire_bytes_follow_the_ring_rule(walks):
    ars = [c for c in walks["collectives"] if c["opcode"] == "all-reduce"]
    assert ars, walks["collectives"]
    for c in ars:
        n = max(c["n"], 2)
        assert c["wire"] == c["payload"] * 2 * (n - 1) / n
    for c in walks["collectives"]:
        assert not c["cross"]                 # 8 devices: one node
    assert walks["collective_s"] > 0 and walks["ici_wire"] > 0


def test_cross_pod_follows_the_reference_rule(walks):
    ranks = walks["cross_ranks"]
    dpp = 4
    for axis, want_cross in (("0", True), ("1", False), ("2", False)):
        assert (len({r // dpp for r in ranks[axis]}) > 1) == want_cross
    assert walks["cross"] == [[2, False, "all-reduce"],
                              [2, False, "all-reduce"],
                              [2, True, "all-reduce"]]


def test_run_cell_writes_every_reference_key(walks):
    rec = walks["record"]
    missing = [k for k in REFERENCE_KEYS if k not in rec]
    assert not missing
    assert rec["n_devices"] == 8 and rec["machine"] == "h100-sxm"
    assert rec["memory"] is None and rec["xla_flops"] is None
    assert not any(k.startswith("adj_") for k in rec)
    assert rec["hlo_flops_per_dev"] > 0 and rec["compute_s"] > 0
    assert rec["collective_ici_s"] > 0 and rec["peak_device_bytes"] > 0
    assert rec["run"]["microbatches"] == 2


def test_folded_microbatches_walk_equals_the_full_walk(walks):
    assert walks["folded_equal"] and walks["folded_coll_equal"]
    a, b = walks["folded_flops"]
    assert a == b > 0


def test_roofline_table_reads_a_dry_run_file(tmp_path, walks):
    from repro_torch.bench import roofline_table
    assert roofline_table.main("cpu", path=str(tmp_path / "none.jsonl")) \
        == [("roofline_table/missing_sweep", 0.0,
             "run repro_torch.launch.dryrun --all first")]
    path = tmp_path / roofline_table.FILENAME
    rec = walks["record"]
    path.write_text(json.dumps(rec) + "\n" + json.dumps(
        {"arch": "x", "shape": "y", "mesh": "single", "error": True}) + "\n")
    rows = roofline_table.main("cpu", path=str(path))
    names = [r[0] for r in rows]
    assert names == [f"roofline/glm4-9b/{rec['shape']}/single",
                     "roofline_table/cells", "roofline_table/fit_cells",
                     "roofline_table/dominant_histogram"]
    assert rows[1][2] == "1"
    assert f"dom={rec['dominant']}" in rows[0][2]


def test_decode_batch_study_smoke_stores_and_reads_back(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="",
               REPRO_WORKSPACE=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.decode_batch_study",
         "--smoke"], env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [line.split(",", 2) for line in proc.stdout.splitlines()
            if line.startswith("decode_batch/")]
    assert [r[0] for r in rows] == ["decode_batch/glm4-9b_b32",
                                    "decode_batch/glm4-9b_b128",
                                    "decode_batch/glm4-9b_amortization"]
    from repro_torch.trace.store import TraceStore
    recs = TraceStore(str(tmp_path / "trace.jsonl")).records(
        "serve/decode_batch/glm4-9b")
    assert len(recs) == 1
    ph = recs[0].phases
    tok = [gb / ph[f"decode_b{gb}"]["bound_overlap_s"] for gb in (32, 128)]
    assert tok[1] > tok[0]
    assert f"tok_s={tok[0]:,.0f}" in rows[0][2]
    assert recs[0].machine == "h100-sxm"
