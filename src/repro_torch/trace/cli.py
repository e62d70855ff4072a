"""``python -m repro_torch.trace`` — record / compare / report measured
rooflines (port of ``repro.trace.cli``).

* ``record``  — build a registry config's train phases (fwd / bwd / opt)
  on the device, walk them and time the same callables, and append one
  record per config to the trace store (``--config`` repeatable, or
  ``--all``): measured wall, achieved FLOP/s and %-of-roofline per
  phase, the bound envelope, the top kernels, git SHA and host;
* ``compare`` — the newest record of each config against the one before
  (``--window``), or two runs (``--base`` / ``--new``); exit code 1 when
  a cell regressed past ``--threshold``, so CI can gate on it;
* ``report``  — the newest stored record, re-rendered without running.

The same three subcommands, with the same flags and the same functions,
are ``python -m repro_torch record / compare / report``.  Every
subcommand runs on the card unless ``--device cpu`` is given.

Examples::

    python -m repro_torch.trace record --config minitron-4b
    python -m repro_torch.trace record --all --iters 10
    python -m repro_torch.trace record --config glm4-9b --device cpu \\
        --scale-wall 2
    python -m repro_torch.trace compare --config minitron-4b
    python -m repro_torch.trace report
"""

from __future__ import annotations

import argparse
import sys
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:
    import torch

PROG = "python -m repro_torch.trace"


# --------------------------------------------------------------------------
# The phases of a registry config
# --------------------------------------------------------------------------

def build_phase_args(config: str, run, *, seq: int = 32, batch: int = 4,
                     smoke: bool = True, n_layers: int | None = None,
                     device: str | torch.device = "cuda"):
    """fwd / bwd / opt phase programs of a registry config under ``run``
    (a :class:`~repro_torch.configs.base.RunConfig`): ``{phase: (fn,
    args)}`` ready for :mod:`repro_torch.trace.collector`.

    The reference takes a built model and ``concrete``; here the config's
    name (``smoke`` picks its smoke variant, ``n_layers`` cuts the depth)
    and the ``device``: real tensors there, or ``"meta"`` for the
    analytical path, which allocates nothing
    (:func:`repro_torch.session.session.build_phases`)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.session.session import TRAIN_PHASES, build_phases
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    phases, _ = build_phases(
        config, phases=TRAIN_PHASES, seq=seq, batch=batch, amp=run.amp,
        fusion=run.fusion, attn_impl=run.attn_impl, ssd_impl=run.ssd_impl,
        impl=run.impl, remat=run.remat, optimizer=run.optimizer,
        smoke=smoke, n_layers=n_layers, device=dev)
    return phases


def build_measured_phases(config: str, *, smoke: bool = True, seq: int = 32,
                          batch: int = 4, amp: str = "O1",
                          fusion: str = "off",
                          device: str | torch.device = "cuda"):
    """(phases, run): fwd / bwd / opt with real tensors on ``device``,
    ready to both walk and time."""
    from repro_torch.configs.base import RunConfig
    run = RunConfig(amp=amp, fusion=fusion)
    return build_phase_args(config, run, seq=seq, batch=batch, smoke=smoke,
                            device=device), run


# --------------------------------------------------------------------------
# Flags shared with ``python -m repro_torch``
# --------------------------------------------------------------------------

def add_common(p) -> None:
    from repro_torch.core.machine import MACHINES
    p.add_argument("--machine", default=None, choices=sorted(MACHINES),
                   help="machine model (default: the datasheet spec of "
                        "the device's card; cpu-host on the host)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")


def add_store(p) -> None:
    p.add_argument("--store", default=None, metavar="PATH",
                   help="trace-store JSONL file (default: trace.jsonl "
                        "of the workspace: $REPRO_WORKSPACE, else "
                        "./.repro-workspace in a checkout)")


def add_workload(p, config_action: str = "store") -> None:
    """A registry config's step: ``--config`` (``config_action``
    ``"append"`` makes it repeatable), shape, AMP and the routes."""
    from repro_torch.configs.base import (ATTN_IMPLS, FUSION_MODES, IMPLS,
                                          OPTIMIZERS, REMAT_MODES, SSD_IMPLS)
    p.add_argument("--config", action=config_action,
                   required=config_action == "store",
                   help="registry config name (see repro_torch.configs)"
                        + ("; repeatable" if config_action == "append"
                           else ""))
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--amp", default="O1", choices=("O0", "O1", "O2"))
    p.add_argument("--fusion", default="off", choices=FUSION_MODES,
                   help="'static' routes the norms, the SwiGLU "
                        "epilogue, the embedding backward, AdamW and "
                        "eligible chunked attention through the "
                        "hand-written kernels; 'auto' (alias "
                        "'measured') only the sites whose measured "
                        "dispatch verdict is fused")
    p.add_argument("--attn-impl", default="einsum", choices=ATTN_IMPLS,
                   help="attention lowering; 'flash' runs the "
                        "flash-attention kernel")
    p.add_argument("--ssd-impl", default="xla", choices=SSD_IMPLS,
                   help="SSD scan lowering (SSM configs); 'kernel' "
                        "runs the ssd_scan kernel")
    p.add_argument("--impl", default="reference", choices=IMPLS,
                   help="DeepCAM lowering: 'reference' runs every norm "
                        "in fp32, 'fused' folds each norm into its conv "
                        "('auto' fusion upgrades the default to "
                        "'fused')")
    p.add_argument("--remat", default="none", choices=REMAT_MODES,
                   help="per-block activation checkpointing: 'dots' "
                        "keeps the products against a weight, 'full' "
                        "only each block's input")
    p.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    smoke = p.add_mutually_exclusive_group()
    smoke.add_argument("--full", action="store_true",
                       help="full config instead of the smoke variant")
    smoke.add_argument("--smoke", action="store_true",
                       help="the smoke variant (the default)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to this many layers (widths kept)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)


def session_from_args(args):
    """The :class:`~repro_torch.session.session.Session` of a subcommand:
    its ``--machine``, ``--device`` and the workspace of ``--store`` (or
    ``--workspace``)."""
    from repro_torch.session.session import Session
    from repro_torch.session.workspace import Workspace
    store = getattr(args, "store", None)
    workspace = (Workspace.for_store(store) if store
                 else getattr(args, "workspace", None))
    return Session(machine=args.machine, device=args.device,
                   workspace=workspace)


# --------------------------------------------------------------------------
# record / compare / report
# --------------------------------------------------------------------------

def cmd_record(args) -> int:
    from repro_torch.configs.registry import ARCHS
    configs = list(ARCHS) if args.all else (args.config or [])
    if not configs:
        print("record: need --config <name> (repeatable) or --all",
              file=sys.stderr)
        return 2
    try:
        s = session_from_args(args)
    except RuntimeError as e:            # no CUDA device for --device cuda
        print(f"record: {e}", file=sys.stderr)
        return 2
    status = 0
    for name in configs:
        try:
            res = s.record(name, seq=args.seq, batch=args.batch,
                           amp=args.amp, fusion=args.fusion,
                           attn_impl=args.attn_impl, ssd_impl=args.ssd_impl,
                           impl=args.impl, remat=args.remat,
                           optimizer=args.optimizer, smoke=not args.full,
                           n_layers=args.layers, iters=args.iters,
                           warmup=args.warmup, scale_wall=args.scale_wall)
        except (RuntimeError, KeyError, NotImplementedError) as e:
            print(f"record: [{name}] {e.args[0] if e.args else e}",
                  file=sys.stderr)
            status = 2
            continue
        print(res.render())
        print(f"run {res.data.run_id} -> {s.workspace.trace_path}")
    return status


def cmd_report(args) -> int:
    try:
        res = session_from_args(args).report(args.config)
    except (RuntimeError, LookupError) as e:
        print(f"report: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render())
    return 0


def cmd_compare(args) -> int:
    try:
        res = session_from_args(args).compare(
            args.config, base=args.base, new=args.new,
            threshold=args.threshold, window=args.window)
    except (RuntimeError, LookupError, ValueError) as e:
        print(f"compare: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render())
    return res.exit_code


def add_record_parser(sub):
    rc = sub.add_parser("record",
                        help="measure configs' phases and append records "
                             "to the trace store")
    add_common(rc)
    add_workload(rc, config_action="append")
    add_store(rc)
    rc.add_argument("--all", action="store_true",
                    help="every LM config of the registry")
    rc.add_argument("--scale-wall", type=float, default=1.0,
                    help="multiply stored wall times (regression drills)")
    rc.set_defaults(fn=cmd_record)
    return rc


def add_report_parser(sub):
    rp = sub.add_parser("report", help="the newest stored record")
    add_common(rp)
    add_store(rp)
    rp.add_argument("--config", default=None,
                    help="newest record of this config (default: any)")
    rp.set_defaults(fn=cmd_report)
    return rp


def add_compare_parser(sub):
    cp = sub.add_parser("compare",
                        help="newest record of each config against the one "
                             "before, or two runs; exit 1 on a regression")
    add_common(cp)
    add_store(cp)
    cp.add_argument("--config", default=None)
    cp.add_argument("--base", default=None, help="base run id (prefix ok)")
    cp.add_argument("--new", default=None, help="new run id (prefix ok)")
    cp.add_argument("--threshold", type=float, default=0.10,
                    help="relative regression threshold (default 0.10)")
    cp.add_argument("--window", type=int, default=2,
                    help="compare the newest against the run window-1 "
                         "records before it (default 2)")
    cp.set_defaults(fn=cmd_compare)
    return cp


def main(argv: Sequence[str] | None = None, prog: str = PROG) -> int:
    ap = argparse.ArgumentParser(
        prog=prog, description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    add_record_parser(sub)
    add_compare_parser(sub)
    add_report_parser(sub)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
