"""``python -m repro_torch sweep`` — run and report cross-config roofline
campaigns (port of ``repro.sweep.cli``, the same flags plus
``--device``).

* ``run``    — expand a sweep spec (registry configs × meshes × AMP
  policies × batches × fusion modes) into a work list, walk every point's
  phases on meta tensors (and, unless ``--no-measure``, time them on the
  device) in a pool of supervised worker processes, and store one
  trace-schema record per point.  ``--smoke`` is the CI preset: 8 smoke
  configs, one device, measured.  ``--faults``, ``--deadline``,
  ``--retries``, ``--backoff`` and ``--resume`` are the campaign's
  resilience (``repro_torch.resilience``).
* ``report`` — render the campaign from the store only (nothing runs
  again): the ranked achieved-vs-bound table across every config, the
  kernel configs each measured point ran with and where they no longer
  match the tune store, and (``--charts``) a roofline gallery.

Measured points run on the card unless ``--device cpu`` is given.

Examples::

    python -m repro_torch sweep run --smoke --device cpu
    python -m repro_torch sweep run --configs family:ssm,minitron-4b \\
        --amp O0,O1 --batch 2,4 --no-measure
    python -m repro_torch sweep run --configs granite-moe-1b-a400m,zamba2-1.2b \\
        --full --seq 2048 --batch 2 --fusion off,static --machine h100-sxm
    python -m repro_torch sweep run --spec campaign.json --workers 4
    python -m repro_torch sweep report --name smoke --charts 4
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Sequence

from repro_torch.sweep.spec import (SweepSpec, parse_int_list, parse_mesh,
                                    smoke_spec)

# the flags that set the sweep's axes: they conflict with --spec / --smoke
# (which set the axes themselves) instead of being ignored
_AXIS_FLAGS = ("configs", "seq", "batch", "amp", "fusion", "mesh", "full")
_AXIS_DEFAULTS = {"configs": "all", "seq": "32", "batch": "4", "amp": "O1",
                  "fusion": "off", "mesh": "1x1", "full": False}


def _store_path(explicit: str | None) -> str:
    from repro_torch.session.workspace import Workspace
    return explicit or Workspace().sweep_path


def spec_from_args(ap: argparse.ArgumentParser, args) -> SweepSpec:
    if args.spec or args.smoke:
        explicit = [f"--{k}" for k in _AXIS_FLAGS
                    if getattr(args, k) is not None]
        if explicit:
            which = "--spec" if args.spec else "--smoke"
            ap.error(f"{' '.join(explicit)} conflict(s) with {which} "
                     "(the axes come from the spec)")
    if args.spec:
        with open(args.spec) as f:
            spec = SweepSpec.from_json(f.read())
    elif args.smoke:
        spec = smoke_spec(args.smoke_configs)
    else:
        flags = {k: (getattr(args, k) if getattr(args, k) is not None
                     else _AXIS_DEFAULTS[k]) for k in _AXIS_FLAGS}
        spec = SweepSpec(
            configs=tuple(s.strip() for s in flags["configs"].split(",")
                          if s.strip()),
            seqs=parse_int_list(flags["seq"]),
            batches=parse_int_list(flags["batch"]),
            amps=tuple(a.strip() for a in flags["amp"].split(",")
                       if a.strip()),
            fusions=tuple(f.strip() for f in flags["fusion"].split(",")
                          if f.strip()),
            meshes=tuple(parse_mesh(m) for m in flags["mesh"].split(",")
                         if m.strip()),
            smoke=not flags["full"])
    # the run policy applies to every source, spec files and presets too
    # (a spec declares the axes; how hard to measure, and against which
    # machine, stay the operator's choice)
    overrides = {"measure": False if args.no_measure else None,
                 "machine": args.machine, "iters": args.iters,
                 "warmup": args.warmup, "name": args.name}
    applied = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(spec, **applied) if applied else spec


def cmd_run(ap: argparse.ArgumentParser, args) -> int:
    import os

    from repro_torch.resilience.faults import FAULT_ENV, parse_plan
    from repro_torch.sweep.aggregate import (latest_per_point,
                                             render_summary, sweep_records)
    from repro_torch.sweep.engine import run_sweep
    from repro_torch.trace.store import TraceStore

    args.store = _store_path(args.store)
    try:
        spec = spec_from_args(ap, args)
        points, skipped = spec.expand()
        if args.faults is not None:
            parse_plan(args.faults)       # reject a typo before any work
            # through the environment, so spawned workers inherit it
            os.environ[FAULT_ENV] = args.faults
    except (KeyError, ValueError, OSError) as e:
        # bad input (an unknown selector, a malformed mesh or spec file):
        # the message and exit 2, not a traceback
        msg = e.args[0] if e.args else e
        print(f"run: {msg}", file=sys.stderr)
        return 2
    print(f"[{spec.name}] {len(points)} point(s) "
          f"({len(skipped)} skipped) -> {args.store}")
    try:
        result = run_sweep(
            spec, store_path=args.store, workers=args.workers,
            cache_dir=None if args.no_cache else (args.cache_dir or ...),
            progress=print,
            deadline_s=args.deadline, retries=args.retries,
            backoff_s=args.backoff, resume=args.resume,
            journal_path=args.journal if args.journal else ...,
            device=args.device)
    except RuntimeError as e:            # no CUDA device for --device cuda
        print(f"run: {e}", file=sys.stderr)
        return 2
    resumed = (f", {result.n_resumed} resumed" if result.n_resumed else "")
    quar = (f" ({result.n_quarantined} quarantined)"
            if result.n_quarantined else "")
    print(f"[{spec.name}] {result.n_ok} ok ({result.n_cached} cached"
          f"{resumed}), {result.n_failed} failed{quar}, "
          f"{len(result.skipped)} skipped")
    if result.n_failed:
        print(f"[{spec.name}] failures:", file=sys.stderr)
        for line in result.failure_summary():
            print(f"  {line}", file=sys.stderr)
    if result.n_ok:
        recs = latest_per_point(sweep_records(TraceStore(args.store),
                                              spec.name))
        print()
        print(render_summary(recs))
    return 1 if result.n_failed else 0


def cmd_report(ap: argparse.ArgumentParser, args) -> int:
    del ap
    import os

    from repro_torch.session.workspace import TUNE_FILENAME
    from repro_torch.sweep.aggregate import (gallery, kernel_config_lines,
                                             latest_per_point,
                                             render_summary, sweep_records,
                                             tune_mismatches)
    from repro_torch.trace.store import TraceStore

    args.store = _store_path(args.store)
    recs = latest_per_point(sweep_records(TraceStore(args.store), args.name))
    if not recs:
        which = f"sweep {args.name!r}" if args.name else "any sweep"
        print(f"report: no records for {which} in {args.store}",
              file=sys.stderr)
        return 2
    print(render_summary(recs))
    for line in kernel_config_lines(recs):
        print(line)
    tune = args.tune_store or os.path.join(
        os.path.dirname(os.path.abspath(args.store)), TUNE_FILENAME)
    for flag in tune_mismatches(recs, tune):
        print(f"! tuned-config mismatch: {flag}")
    if args.charts:
        print()
        print(gallery(recs, max_charts=args.charts))
    return 0


def main(argv: Sequence[str] | None = None,
         prog: str = "python -m repro_torch sweep") -> int:
    from repro_torch.core.machine import MACHINES

    ap = argparse.ArgumentParser(
        prog=prog, description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    store_help = ("JSONL store path (default: sweep.jsonl of the "
                  "workspace: $REPRO_WORKSPACE, else ./.repro-workspace "
                  "in a checkout)")
    run = sub.add_parser("run", help="expand a spec, run every point, "
                                     "store one record per point")
    run.add_argument("--spec", default=None,
                     help="sweep spec JSON file (instead of the axis flags)")
    run.add_argument("--smoke", action="store_true",
                     help="CI preset: 8 smoke configs, 1x1 mesh, measured")
    run.add_argument("--smoke-configs", type=int, default=8,
                     help="how many configs the --smoke preset sweeps")
    run.add_argument("--name", default=None,
                     help="campaign name, stamped into every record's meta "
                          "(default: the spec's or preset's, else 'sweep')")
    run.add_argument("--configs", default=None,
                     help="comma list of selectors: names, family:<fam>, "
                          "all (default all)")
    run.add_argument("--seq", default=None,
                     help="comma list of seq lengths (default 32)")
    run.add_argument("--batch", default=None,
                     help="comma list of batches (default 4)")
    run.add_argument("--amp", default=None,
                     help="comma list of AMP policies (default O1)")
    run.add_argument("--fusion", default=None,
                     help="comma list of fused-kernel modes: off, static, "
                          "auto (default off); 'off,static' sweeps every "
                          "config plain against the hand-written kernels")
    run.add_argument("--mesh", default=None,
                     help="comma list of DxM meshes (data x model), e.g. "
                          "1x1,2x4 (default 1x1); a point on more than one "
                          "device fails until the port shards (its "
                          "distributed level)")
    run.add_argument("--machine", default=None, choices=sorted(MACHINES),
                     help="machine model the bounds are against (default "
                          "cpu-host)")
    run.add_argument("--device", default="cuda",
                     help="where measured points run: 'cuda' (default) or "
                          "'cpu'; analytical points run on meta tensors")
    run.add_argument("--no-measure", action="store_true",
                     help="analytical bounds only (cacheable, nothing runs "
                          "on a device)")
    run.add_argument("--full", action="store_true", default=None,
                     help="full configs instead of smoke variants")
    run.add_argument("--iters", type=int, default=None)
    run.add_argument("--warmup", type=int, default=None)
    run.add_argument("--workers", type=int, default=None,
                     help="worker processes (default: min(4, cpus) for "
                          "analytical sweeps, 1 for measured ones — "
                          "concurrent measurements share the device; "
                          "0 = inline, single-device points only)")
    run.add_argument("--store", default=None, help=store_help)
    run.add_argument("--cache-dir", default=None,
                     help="per-point analysis cache (analytical points; "
                          "default: sweep_cache beside the store)")
    run.add_argument("--no-cache", action="store_true")
    run.add_argument("--resume", action="store_true",
                     help="skip points whose record already landed for "
                          "this campaign (journal and store, keyed by the "
                          "point's content hash): continue a crashed or "
                          "quarantine-cut run")
    run.add_argument("--deadline", type=float, default=None,
                     help="per-point wall-clock deadline in seconds; a "
                          "point past it has its worker killed and "
                          "replaced (one failed attempt).  A worker's "
                          "first point loads the kernel libraries: keep "
                          "the deadline above that")
    run.add_argument("--retries", type=int, default=1,
                     help="extra attempts of a failed point before it is "
                          "quarantined (default 1)")
    run.add_argument("--backoff", type=float, default=0.25,
                     help="base retry backoff in seconds, doubling each "
                          "round (default 0.25)")
    run.add_argument("--faults", default=None,
                     help="fault-injection plan (the REPRO_FAULTS grammar, "
                          "e.g. 'crash_point:0;hang_point:1:30'), passed "
                          "to the workers")
    run.add_argument("--journal", default=None,
                     help="campaign journal path (default: "
                          "sweep_journal.jsonl beside the store)")
    run.set_defaults(fn=cmd_run, parser=run)

    rep = sub.add_parser("report", help="render the stored campaign: ranked "
                                        "table and roofline gallery")
    rep.add_argument("--store", default=None, help=store_help)
    rep.add_argument("--name", default=None,
                     help="campaign name (default: every sweep record)")
    rep.add_argument("--charts", type=int, default=0,
                     help="also render up to N per-point roofline charts")
    rep.add_argument("--tune-store", default=None,
                     help="tune store to check the measured points' kernel "
                          "configs against (default: tune.json beside the "
                          "store)")
    rep.set_defaults(fn=cmd_report, parser=rep)

    args = ap.parse_args(argv)
    return args.fn(args.parser, args)


if __name__ == "__main__":
    sys.exit(main())
