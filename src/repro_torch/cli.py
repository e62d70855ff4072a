"""``python -m repro_torch`` — the port's workflow as a CLI (mirrors the
``characterize``, ``profile``, ``record``, ``report`` and ``compare``
subcommands of ``python -m repro``).

* ``characterize`` — machine model: the card's datasheet ceilings, or
  (``--empirical``) the ceilings the hand-written ERT kernels measure,
  best-of-tuned through the workspace's tune store (``--untuned``: the
  default launch configs, timed once);
* ``profile``      — aten-op walk of a registry config's fwd / bwd / opt
  phases (kernel table, three-term bound, roofline chart) at ``--fusion``
  ``off`` or ``static``, ``--attn-impl`` ``einsum``, ``chunked`` or
  ``flash``, ``--ssd-impl`` ``xla`` or ``kernel``, ``--remat`` ``none``,
  ``dots`` or ``full``, ``--optimizer`` ``adamw`` or ``adafactor`` and
  (DeepCAM) ``--impl`` ``reference`` or ``fused``; ``--measure`` also
  times them on the device;
* ``record``       — measure the phases and append a record to the trace
  store (``--store``, default the workspace's ``trace.jsonl``);
  ``--scale-wall`` multiplies the stored wall times (regression drills);
* ``serve``        — continuous-batching serving of a seeded arrival
  trace (``repro_torch.serve``); prefill and decode recorded as separate
  phases of a ``serve/<config>`` record; exit code 1 when the latency
  gate fails;
* ``report``       — the newest stored record, re-rendered;
* ``compare``      — the newest record of each config against the one
  before; exit code 1 when a cell regressed past 10%;
* ``tune``         — kernel autotuning (``search`` / ``show`` / ``apply``)
  and the dispatch table (``dispatch search`` / ``show`` / ``apply``),
  forwarded to ``repro_torch.tune.cli``.

Every subcommand runs on the card unless ``--device cpu`` is given.

Examples::

    python -m repro_torch characterize --empirical
    python -m repro_torch profile --config glm4-9b --full --measure --charts 1
    python -m repro_torch profile --config glm4-9b --device cpu --measure
    python -m repro_torch profile --config glm4-9b --device cpu \
        --fusion static --phase bwd
    python -m repro_torch profile --config mamba2-1.3b --device cpu \
        --ssd-impl kernel --fusion static --phase bwd
    python -m repro_torch profile --config zamba2-1.2b --device cpu \
        --ssd-impl kernel --fusion static --phase bwd
    python -m repro_torch profile --config minitron-4b --device cpu \
        --remat full --optimizer adafactor
    python -m repro_torch profile --config deepcam --smoke --device cpu \
        --impl fused
    python -m repro_torch record --config glm4-9b --full --layers 4 \
        --seq 2048 --batch 2 --fusion static --attn-impl flash
    python -m repro_torch serve --config glm4-9b --device cpu
    python -m repro_torch serve --config glm4-9b --full --fusion static \
        --slots 8 --max-len 2048 --prefill-chunk 256
    python -m repro_torch report
    python -m repro_torch compare
    python -m repro_torch tune search --device cpu --smoke
    python -m repro_torch tune dispatch search --config glm4-9b --device cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

PROG = "python -m repro_torch"


def _session(args):
    from repro_torch.session.session import Session
    from repro_torch.session.workspace import Workspace
    store = getattr(args, "store", None)
    return Session(machine=args.machine, device=args.device,
                   workspace=Workspace.for_store(store) if store else None)


def cmd_characterize(args) -> int:
    try:
        s = _session(args)
    except RuntimeError as e:            # no CUDA device for --device cuda
        print(f"characterize: {e}", file=sys.stderr)
        return 2
    print(s.characterize(empirical=args.empirical, tuned=not args.untuned,
                         smoke=args.smoke).render())
    return 0


def cmd_profile(args) -> int:
    try:
        s = _session(args)
    except RuntimeError as e:
        print(f"profile: {e}", file=sys.stderr)
        return 2
    try:
        res = s.profile(args.config,
                        phases=tuple(args.phase or ("fwd", "bwd", "opt")),
                        seq=args.seq, batch=args.batch, amp=args.amp,
                        fusion=args.fusion, attn_impl=args.attn_impl,
                        ssd_impl=args.ssd_impl, impl=args.impl,
                        remat=args.remat, optimizer=args.optimizer,
                        smoke=not args.full, n_layers=args.layers,
                        measure=args.measure,
                        iters=args.iters,
                        warmup=args.warmup)
    except (KeyError, NotImplementedError) as e:
        print(f"profile: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render(charts=args.charts, top_kernels=args.top))
    return 0


def cmd_record(args) -> int:
    try:
        s = _session(args)
        res = s.record(args.config, seq=args.seq, batch=args.batch,
                       amp=args.amp, fusion=args.fusion,
                       attn_impl=args.attn_impl, ssd_impl=args.ssd_impl,
                       impl=args.impl, remat=args.remat,
                       optimizer=args.optimizer, smoke=not args.full,
                       n_layers=args.layers,
                       iters=args.iters,
                       warmup=args.warmup, scale_wall=args.scale_wall)
    except (RuntimeError, KeyError, NotImplementedError) as e:
        print(f"record: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render())
    print(f"run {res.data.run_id} -> {s.workspace.trace_path}")
    return 0


def cmd_serve(args) -> int:
    try:
        s = _session(args)
        res = s.serve(args.config, n_requests=args.requests,
                      trace=args.trace, rate=args.rate, burst=args.burst,
                      seed=args.seed, n_slots=args.slots,
                      max_len=args.max_len,
                      prefill_chunk=args.prefill_chunk,
                      page_size=args.page_size, amp=args.amp,
                      fusion=args.fusion, smoke=not args.full,
                      max_ticks=args.max_ticks)
    except (RuntimeError, KeyError, NotImplementedError, ValueError) as e:
        # no card, an unknown config, a family the engine does not serve
        print(f"serve: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render())
    print(f"run {res.data[0].run_id} -> {s.workspace.trace_path}")
    return res.exit_code


def cmd_report(args) -> int:
    try:
        res = _session(args).report(args.config)
    except (RuntimeError, LookupError) as e:
        print(f"report: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render())
    return 0


def cmd_compare(args) -> int:
    try:
        res = _session(args).compare(args.config)
    except (RuntimeError, LookupError) as e:
        print(f"compare: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render())
    return res.exit_code


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.core.machine import MACHINES

    ap = argparse.ArgumentParser(
        prog=PROG, description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p) -> None:
        p.add_argument("--machine", default=None, choices=sorted(MACHINES),
                       help="machine model (default: the datasheet spec of "
                            "the device's card; cpu-host on the host)")
        p.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu'")

    ch = sub.add_parser("characterize",
                        help="machine model: datasheet or measured ERT "
                             "ceilings (paper §II-A)")
    common(ch)
    ch.add_argument("--empirical", action="store_true",
                    help="measure the device's ceilings with the ERT kernels")
    ch.add_argument("--untuned", action="store_true",
                    help="time the default launch configs once instead of "
                         "taking the best-of-tuned winners from the "
                         "workspace's tune store")
    ch.add_argument("--smoke", action="store_true",
                    help="tiny problem sizes (for a quick check)")
    ch.set_defaults(fn=cmd_characterize)

    def workload(p) -> None:
        from repro_torch.configs.base import (ATTN_IMPLS, FUSION_MODES,
                                              IMPLS, OPTIMIZERS, REMAT_MODES,
                                              SSD_IMPLS)
        p.add_argument("--config", required=True,
                       help="registry config name (see repro_torch.configs)")
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
                       help="cut the depth to this many layers (widths "
                            "kept)")
        p.add_argument("--iters", type=int, default=5)
        p.add_argument("--warmup", type=int, default=2)

    def store(p) -> None:
        p.add_argument("--store", default=None, metavar="PATH",
                       help="trace-store JSONL file (default: trace.jsonl "
                            "of the workspace: $REPRO_WORKSPACE, else "
                            "./.repro-workspace in a checkout)")

    pr = sub.add_parser("profile",
                        help="aten-op walk of a registry config "
                             "(paper §II-B)")
    common(pr)
    workload(pr)
    pr.add_argument("--phase", action="append", choices=("fwd", "bwd", "opt"),
                    help="phase to profile (repeatable; default all three)")
    pr.add_argument("--measure", action="store_true",
                    help="also run the same callable on the device and "
                         "fold measured time in")
    pr.add_argument("--charts", type=int, default=0,
                    help="render up to N per-phase roofline charts")
    pr.add_argument("--top", type=int, default=10,
                    help="kernel-table rows per phase")
    pr.set_defaults(fn=cmd_profile)

    rc = sub.add_parser("record",
                        help="measure a config's phases and append a record "
                             "to the trace store")
    common(rc)
    workload(rc)
    store(rc)
    rc.add_argument("--scale-wall", type=float, default=1.0,
                    help="multiply stored wall times (regression drills)")
    rc.set_defaults(fn=cmd_record)

    from repro_torch.configs.base import FUSION_MODES
    sv = sub.add_parser("serve",
                        help="continuous-batching serving under a seeded "
                             "arrival trace; prefill/decode recorded as "
                             "separate phases (repro_torch.serve)")
    common(sv)
    store(sv)
    sv.add_argument("--config", required=True,
                    help="registry config name of a dense or MoE model "
                         "(the engine serves those families)")
    sv.add_argument("--requests", type=int, default=16,
                    help="arrival-trace length (default 16)")
    sv.add_argument("--trace", default="poisson",
                    choices=("poisson", "bursty"),
                    help="arrival process (default poisson)")
    sv.add_argument("--rate", type=float, default=1.0,
                    help="arrivals (or bursts) per tick (default 1.0)")
    sv.add_argument("--burst", type=int, default=4,
                    help="requests per burst for --trace bursty")
    sv.add_argument("--seed", type=int, default=0,
                    help="workload + weight-init seed (default 0)")
    sv.add_argument("--slots", type=int, default=4,
                    help="concurrent sequence slots (default 4)")
    sv.add_argument("--max-len", type=int, default=64,
                    help="max tokens per sequence incl. prompt")
    sv.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens prefilled per tick (default 16)")
    sv.add_argument("--page-size", type=int, default=16,
                    help="KV-cache page size in tokens (default 16)")
    sv.add_argument("--amp", default="O1", choices=("O0", "O1", "O2"))
    sv.add_argument("--fusion", default="off", choices=FUSION_MODES)
    sv.add_argument("--full", action="store_true",
                    help="full config instead of the smoke variant")
    sv.add_argument("--max-ticks", type=int, default=4096,
                    help="tick budget before the run is cut off")
    sv.set_defaults(fn=cmd_serve)

    rp = sub.add_parser("report", help="the newest stored record")
    common(rp)
    store(rp)
    rp.add_argument("--config", default=None,
                    help="newest record of this config (default: any)")
    rp.set_defaults(fn=cmd_report)

    cp = sub.add_parser("compare",
                        help="newest record of each config against the one "
                             "before; exit 1 on a regression")
    common(cp)
    store(cp)
    cp.add_argument("--config", default=None)
    cp.set_defaults(fn=cmd_compare)

    # listed for --help; ``main`` forwards ``tune ...`` before parsing
    tu = sub.add_parser("tune", add_help=False,
                        help="kernel autotuning and the dispatch table "
                             "(try `tune --help`)")
    tu.add_argument("rest", nargs=argparse.REMAINDER)
    return ap


def main(argv: Sequence[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["tune"]:
        from repro_torch.tune.cli import main as tune_main
        try:
            return tune_main(argv[1:], prog=f"{PROG} tune")
        except SystemExit as e:             # --help or a usage error
            return int(e.code or 0)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
