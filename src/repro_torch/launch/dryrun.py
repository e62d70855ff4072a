"""Multi-pod dry run: walk every (arch × shape × mesh) cell per device
(port of ``repro.launch.dryrun``).

For each cell this builds the production step function (``train_step``
for ``train_*``, the forward for ``prefill_*``, ``decode_fn`` for
``decode_*`` / ``long_*``), gives it **meta DTensors** under the
production shardings (``repro_torch.distributed.sharding``: nothing is
allocated) on the (16, 16) single-pod or the (2, 16, 16) multi-pod mesh
(``launch.mesh``: this process is rank 0 of a fake group of 256 / 512
ranks), and walks it op by op as rank 0 runs it
(``core.op_analysis.analyze_fn``): the local ops at their local shapes
and every collective DTensor issues.  From the walk it writes the
reference's record:

* the hierarchical-roofline terms per device (compute / memory /
  collective seconds on the machine's datasheet spec, ``h100-sxm`` by
  default), the dominant term, the MODEL_FLOPS ratio and the zero-AI
  census — analytical figures, not measurements;
* the collectives' wire bytes, split by ``devices_per_pod``: the
  smaller of the mesh's devices per pod and the machine's cards per
  NVLink node (``MachineSpec.cards_per_node``, 8 on an HGX H100), so a
  group that leaves a node is ``dcn`` (the record's ``devices_per_pod``
  says which was used);
* ``peak_device_bytes``: the walk's high-water mark of live local
  tensor bytes (its arguments — this rank's shards of the state and the
  batch — then every op's outputs until freed), and ``fits_hbm``, that
  mark against the machine's HBM.

Left out: ``memory``, ``xla_flops`` and ``xla_bytes`` are XLA's own
numbers (``memory_analysis`` / ``cost_analysis`` of a compiled program)
and are ``None``; the reference's ``adj_*`` fields model its Pallas
kernels swapped in for XLA lowerings (``core/kernel_adjust.py``), which
the port does not need — its walk sees the kernels it runs.

Gradient accumulation runs the same microbatch body ``microbatches``
times (glm4-9b's and kimi-k2's ``train_4k`` take 8), so the walk runs
one microbatch and counts each of its ops 8 times, with the
accumulation counted as often as it runs and the optimizer once
(``op_analysis.trips``, the reference's while-loop trip multiplier); a
smoke test holds the folded walk exact against the full one.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out dryrun_baseline.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, RunConfig, ShapeSpec
from repro_torch.configs.registry import ARCHS, cells, get_config
from repro_torch.core.machine import get_machine
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.roofline import model_flops_ratio, roofline_terms
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (devices_per_pod, make_production_mesh,
                                     merge_data_axes)
from repro_torch.models import api as M
from repro_torch.models.params import init
from repro_torch.train import step as TS


# --------------------------------------------------------------------------
# Per-cell run policy (the baseline the hillclimbs start from)
# --------------------------------------------------------------------------

def default_run(cfg: ModelConfig, shape: ShapeSpec) -> RunConfig:
    """The reference's per-cell policy, as written."""
    n = cfg.param_count()
    if shape.kind == "train":
        return RunConfig(
            amp="O2" if n >= 500e9 else "O1",
            remat="full" if n >= 1e9 else "none",
            tp=True,
            fsdp=n >= 8e9,
            sp=n >= 500e9,
            optimizer="adafactor" if n >= 500e9 else "adamw",
            microbatches=max(1, min(8, shape.global_batch // 32)),
            attn_impl="chunked" if shape.seq_len >= 4096 else "einsum",
            attn_chunk=512,
        )
    if shape.kind == "prefill":
        return RunConfig(amp="O1", tp=True, fsdp=n >= 50e9,
                         attn_impl="chunked", attn_chunk=512)
    return RunConfig(amp="O1", tp=True, fsdp=n >= 50e9)


# --------------------------------------------------------------------------
# Cell → (fn, sharded input specs)
# --------------------------------------------------------------------------

def build_cell(arch: str, shape: ShapeSpec, mesh, run: RunConfig | None = None,
               cfg: ModelConfig | None = None):
    """(cfg, run, fn, args, donate) of one cell: ``args`` are meta
    DTensors under the production shardings on ``mesh`` (the specs on
    its axes, the DTensors on ``launch.mesh.merge_data_axes(mesh)``).
    ``cfg`` stands in for the registry's (a smoke config, a cut
    depth)."""
    cfg = cfg or get_config(arch)
    run = run or default_run(cfg, shape)
    model = M.build(cfg)
    on = merge_data_axes(mesh)

    batch_abs = M.synthetic_batch(cfg, shape, shape.global_batch, None,
                                  "meta")
    batch = shd.with_sharding(batch_abs, shd.named(
        shd.shard_batch_dim(batch_abs, mesh, run), on))

    if shape.kind == "train":
        state_abs = TS.init_state(model, run, None, "meta")
        state = shd.with_sharding(state_abs, shd.named(
            TS.state_specs(model, run, mesh, state_abs), on))
        fn = TS.make_train_step(model, run)
        return cfg, run, fn, (state, batch), (0,)

    # inference holds the weights in the serving dtype (bf16 under O1/O2)
    params_abs = init(model.spec, None, run.compute_dtype, "meta")
    params = shd.with_sharding(params_abs, shd.named(
        shd.param_shardings(model.spec, mesh, run), on))

    if shape.kind == "prefill":
        def fwd(params, batch):
            return model.forward_fn(params, batch, run)
        return cfg, run, fwd, (params, batch), ()

    state_abs = M.decode_state_specs(cfg, shape)
    state = shd.with_sharding(state_abs, shd.named(
        shd.decode_state_shardings(state_abs, mesh, run), on))

    def serve_step(params, batch, state):
        return model.decode_fn(params, batch, state, run)

    return cfg, run, serve_step, (params, batch, state), (2,)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Headline MODEL_FLOPS: 6·N_active·tokens (train), 2·N_active
    (infer)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str | ShapeSpec, mesh_kind: str,
             machine_name: str = "h100-sxm",
             run_overrides: dict | None = None,
             return_profile: bool = False, mesh=None,
             cfg: ModelConfig | None = None, fold_loops: bool = True):
    """Walk one (arch, shape, mesh) cell and analyze it → its record, or
    ``(record, ProfileResult)`` with ``return_profile``.

    ``shape_name`` names a cell of ``SHAPES`` or is a ShapeSpec itself
    (``bench.decode_batch_study``'s batches); ``mesh`` replaces the
    production mesh of ``mesh_kind`` and ``cfg`` the registry's config
    (tests walk smoke configs on small meshes); ``fold_loops=False``
    walks every microbatch."""
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    cfg = cfg or get_config(arch)
    run = default_run(cfg, shape)
    if run_overrides:
        run = dataclasses.replace(run, **run_overrides)

    machine = get_machine(machine_name)
    n_dev = mesh.size()
    dpp = min(devices_per_pod(mesh), machine.cards_per_node or n_dev)
    t0 = time.time()
    cfg, run, fn, args, _ = build_cell(arch, shape, mesh, run, cfg)
    mm_class = "bf16" if run.compute_dtype == torch.bfloat16 else "f32"
    analysis = analyze_fn(fn, args, matmul_class=mm_class,
                          devices_per_pod=dpp, fold_loops=fold_loops)
    t_walk = time.time() - t0

    terms = roofline_terms(analysis, machine)
    prof = ProfileResult(name=f"{arch}/{shape.name}/{mesh_kind}",
                         analysis=analysis, terms=terms,
                         peak_device_bytes=analysis.peak_bytes)
    mf = model_flops(cfg, shape)
    census = analysis.zero_ai_census()
    fits = analysis.peak_bytes <= machine.hbm.capacity_bytes

    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "n_devices": n_dev,
        "run": {k: getattr(run, k) for k in
                ("amp", "remat", "tp", "fsdp", "sp", "attn_impl",
                 "attn_chunk", "optimizer", "microbatches",
                 "sharded_logits")},
        "compile_s": round(t_walk, 2),
        "machine": machine.name,
        "devices_per_pod": dpp,
        # roofline terms (seconds, per device; analytical)
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_ici_s": terms.collective_ici_s,
        "collective_dcn_s": terms.collective_dcn_s,
        "dominant": terms.dominant,
        "bound_overlap_s": terms.bound_overlap_s,
        "roofline_fraction": terms.roofline_fraction,
        # raw quantities
        "hlo_flops_per_dev": analysis.total_flops,
        "flops_by_class": terms.flops_by_class,
        "hbm_bytes_per_dev": analysis.total_hbm_bytes,
        "ici_wire_bytes": terms.ici_wire_bytes,
        "dcn_wire_bytes": terms.dcn_wire_bytes,
        "n_collectives": sum(c.exec_count for c in analysis.collectives),
        "model_flops_global": mf,
        "model_flops_ratio": model_flops_ratio(mf, analysis, n_dev),
        # memory fit
        "peak_device_bytes": analysis.peak_bytes,
        "fits_hbm": fits,
        # XLA's own numbers: no counterpart (the module docstring)
        "memory": None,
        "xla_flops": None,
        "xla_bytes": None,
        "n_kernels": len(analysis.kernels),
        "zero_ai": {k: v[0] for k, v in census.items()},
    }
    if return_profile:
        return rec, prof
    return rec


def describe(rec: dict) -> str:
    """One line of a record: terms, dominant, collectives, peak, fit."""
    coll = rec["collective_ici_s"] + rec["collective_dcn_s"]
    wire = rec["ici_wire_bytes"] + rec["dcn_wire_bytes"]
    return (f"walk {rec['compile_s']}s | "
            f"compute {rec['compute_s']*1e3:.2f}ms "
            f"memory {rec['memory_s']*1e3:.2f}ms "
            f"coll {coll*1e3:.2f}ms ({rec['n_collectives']} collectives, "
            f"{wire/2**30:.2f} GiB on the wire) | "
            f"dominant={rec['dominant']} "
            f"frac={rec['roofline_fraction']:.3f} | "
            f"peak {rec['peak_device_bytes']/2**30:.2f} GiB/dev "
            f"fits={rec['fits_hbm']}")


def _parse_sets(pairs: list[str]) -> dict:
    overrides: dict = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        overrides[k] = (v if not v.replace("-", "").isdigit() else int(v))
        if v in ("True", "False"):
            overrides[k] = v == "True"
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="walk (arch x shape x mesh) cells per device on meta "
                    "DTensors and write their roofline records")
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true",
                    help="every applicable (arch x shape) cell")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--machine", default="h100-sxm")
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig override, e.g. --set remat=dots")
    args = ap.parse_args(argv)
    overrides = _parse_sets(args.set)

    if args.all:
        todo = [(a, s.name) for a in ARCHS for s in cells(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    out_f = open(args.out, "a") if args.out else None
    try:
        for arch, shape_name in todo:
            for mesh_kind in meshes:
                tag = f"{arch} × {shape_name} × {mesh_kind}"
                try:
                    rec = run_cell(arch, shape_name, mesh_kind, args.machine,
                                   overrides or None)
                except Exception:
                    failures += 1
                    print(f"[FAIL] {tag}")
                    traceback.print_exc()
                    if out_f:
                        out_f.write(json.dumps(
                            {"arch": arch, "shape": shape_name,
                             "mesh": mesh_kind, "error": True}) + "\n")
                        out_f.flush()
                    continue
                print(f"[ok] {tag}: {describe(rec)}", flush=True)
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
    finally:
        if out_f:
            out_f.close()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
