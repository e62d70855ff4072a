"""``python -m repro_torch`` — the port's workflow as a CLI (mirrors the
``characterize`` and ``profile`` subcommands of ``python -m repro``).

* ``characterize`` — machine model: the card's datasheet ceilings, or
  (``--empirical``) the ceilings the hand-written ERT kernels measure;
* ``profile``      — aten-op walk of a registry config's fwd / bwd / opt
  phases (kernel table, three-term bound, roofline chart) at ``--fusion``
  ``off`` or ``static``; ``--measure`` also times them on the device.

Both run on the card unless ``--device cpu`` is given.

Examples::

    python -m repro_torch characterize --empirical
    python -m repro_torch profile --config glm4-9b --full --measure --charts 1
    python -m repro_torch profile --config glm4-9b --device cpu --measure
    python -m repro_torch profile --config glm4-9b --device cpu \
        --fusion static --phase bwd
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

PROG = "python -m repro_torch"


def _session(args):
    from repro_torch.session.session import Session
    return Session(machine=args.machine, device=args.device)


def cmd_characterize(args) -> int:
    try:
        s = _session(args)
    except RuntimeError as e:            # no CUDA device for --device cuda
        print(f"characterize: {e}", file=sys.stderr)
        return 2
    print(s.characterize(empirical=args.empirical, smoke=args.smoke).render())
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
                        fusion=args.fusion, smoke=not args.full,
                        n_layers=args.layers, measure=args.measure,
                        iters=args.iters, warmup=args.warmup)
    except (KeyError, NotImplementedError) as e:
        print(f"profile: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(res.render(charts=args.charts, top_kernels=args.top))
    return 0


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
    ch.add_argument("--smoke", action="store_true",
                    help="tiny problem sizes (for a quick check)")
    ch.set_defaults(fn=cmd_characterize)

    pr = sub.add_parser("profile",
                        help="aten-op walk of a registry config "
                             "(paper §II-B)")
    common(pr)
    pr.add_argument("--config", required=True,
                    help="registry config name (see repro_torch.configs)")
    pr.add_argument("--phase", action="append", choices=("fwd", "bwd", "opt"),
                    help="phase to profile (repeatable; default all three)")
    pr.add_argument("--seq", type=int, default=32)
    pr.add_argument("--batch", type=int, default=4)
    pr.add_argument("--amp", default="O1", choices=("O0", "O1", "O2"))
    pr.add_argument("--fusion", default="off", choices=("off", "static"),
                    help="'static' routes the norms, the SwiGLU epilogue, "
                         "the embedding backward and AdamW through the "
                         "fused kernels")
    pr.add_argument("--full", action="store_true",
                    help="full config instead of the smoke variant")
    pr.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    pr.add_argument("--measure", action="store_true",
                    help="also run the same callable on the device and "
                         "fold measured time in")
    pr.add_argument("--iters", type=int, default=5)
    pr.add_argument("--warmup", type=int, default=2)
    pr.add_argument("--charts", type=int, default=0,
                    help="render up to N per-phase roofline charts")
    pr.add_argument("--top", type=int, default=10,
                    help="kernel-table rows per phase")
    pr.set_defaults(fn=cmd_profile)
    return ap


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
