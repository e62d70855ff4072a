"""``python -m repro_torch net`` / ``python -m repro_torch.net`` — the
interconnect level (port of ``repro.net.cli``, the same flags and exit
codes).

* ``characterize`` — measure the collective ceilings (ICI / DCN
  bandwidth and latency) of a machine key on ranks of a real process
  group and store them under that key in the workspace tune store: gloo
  ranks on 127.0.0.1 for ``cpu-host``, one NCCL rank a card for a card's
  key (which needs ``--devices`` cards on this host).  A second run of
  the same key is a store hit that times nothing unless ``--force``.
  Exit code 2 when it cannot measure.
* ``report``       — the stored ceilings with their provenance and the
  mesh-scale ranking over stored sweep records: which points are
  network-bound, and where each config flips.  Exit code 1 when no
  point is stored.

``--machine`` defaults to the datasheet key of this host's card;
``cpu-host`` (the host's CPU over loopback) only when asked.

Examples::

    python -m repro_torch net characterize --machine cpu-host --devices 8 --smoke
    python -m repro_torch net report --machine cpu-host --sweep netscale
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

PROG = "python -m repro_torch net"


def _machine(args) -> str:
    """``--machine``, else the datasheet key of this host's card."""
    if args.machine:
        return args.machine
    import torch

    from repro_torch.core.machine import datasheet_for
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card on this host to take the machine "
                           "key from: pass --machine (cpu-host measures "
                           "the host's CPU over loopback)")
    return datasheet_for(torch.cuda.get_device_name(0)).name


def cmd_characterize(args) -> int:
    from repro_torch.net.characterize import backend_for, characterize_net
    try:
        machine = _machine(args)
        out = characterize_net(
            machine, n_devices=args.devices,
            sizes=tuple(int(s) for s in args.sizes.split(","))
            if args.sizes else None,
            iters=args.iters, warmup=args.warmup, store=args.store,
            force=args.force, smoke=args.smoke,
            deadline_s=args.deadline)
    except (RuntimeError, ValueError) as e:
        print(f"net characterize: {e}", file=sys.stderr)
        return 2
    where = ("gloo rank(s) on this host's CPU" if backend_for(machine) ==
             "gloo" else "NCCL rank(s), one a card")
    tag = "store hit — nothing re-timed" if out["cached"] else \
        f"measured over {out['n_devices']} {where}"
    print(f"net characterize: {tag} (store {out['store']})")
    from repro_torch.net.report import ceilings_text
    print(ceilings_text(out["machine"], args.store))
    for leg, ops in sorted(out.get("ops", {}).items()):
        for op, fit in sorted(ops.items()):
            print(f"    {leg}/{op:<15} {fit['bytes_per_s'] / 1e9:8.3f} "
                  f"GB/s  lat {fit['latency_s'] * 1e6:7.1f} us")
    return 0


def cmd_report(args) -> int:
    from repro_torch.net.report import render_net_report
    from repro_torch.session.workspace import Workspace
    from repro_torch.sweep.aggregate import latest_per_point, sweep_records
    from repro_torch.trace.store import TraceStore
    try:
        machine = _machine(args)
    except RuntimeError as e:
        print(f"net report: {e}", file=sys.stderr)
        return 2
    store = TraceStore(args.sweep_store or Workspace().sweep_path)
    recs = latest_per_point(sweep_records(store, args.sweep))
    rows = {k: r for k, r in recs.items()
            if args.config is None or r.config == args.config}
    print(render_net_report(rows, machine=machine, store=args.store))
    # as Session.net_report: the ceilings always print, an empty ranking
    # (nothing swept yet) exits 1
    return 0 if rows else 1


def build_parser(prog: str | None = None) -> argparse.ArgumentParser:
    from repro_torch.core.machine import MACHINES
    ap = argparse.ArgumentParser(
        prog=prog or PROG, description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ch = sub.add_parser("characterize",
                        help="measure collective ceilings into the "
                             "workspace tune store (store hit on re-run)")
    ch.add_argument("--machine", default=None, choices=sorted(MACHINES),
                    help="machine key the ceilings are stored under "
                         "(default: this host's card's datasheet key)")
    ch.add_argument("--devices", type=int, default=8,
                    help="ranks (even; default 8)")
    ch.add_argument("--sizes", default=None,
                    help="comma-separated fp32 elements a rank per sample "
                         "(default: built-in sweep)")
    ch.add_argument("--iters", type=int, default=3)
    ch.add_argument("--warmup", type=int, default=1)
    ch.add_argument("--smoke", action="store_true",
                    help="small size sweep (CI preset)")
    ch.add_argument("--force", action="store_true",
                    help="measure again even when the store already has "
                         "ceilings for this machine key")
    ch.add_argument("--store", default=None,
                    help="tune-store path (default: workspace tune.json)")
    ch.add_argument("--deadline", type=float, default=900.0,
                    help="kill deadline of the measurement and its ranks, "
                         "seconds (default 900)")
    ch.set_defaults(fn=cmd_characterize)

    rp = sub.add_parser("report",
                        help="stored ceilings + mesh-scale network-bound "
                             "ranking over stored sweep records")
    rp.add_argument("--machine", default=None, choices=sorted(MACHINES),
                    help="machine key to read ceilings for (default: "
                         "this host's card's datasheet key)")
    rp.add_argument("--sweep", default=None,
                    help="restrict to one campaign name")
    rp.add_argument("--config", default=None,
                    help="restrict to one registry config")
    rp.add_argument("--store", default=None,
                    help="tune-store path (default: workspace tune.json)")
    rp.add_argument("--sweep-store", default=None,
                    help="sweep-store path (default: workspace "
                         "sweep.jsonl)")
    rp.set_defaults(fn=cmd_report)
    return ap


def main(argv: Sequence[str] | None = None, prog: str | None = None) -> int:
    args = build_parser(prog).parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
