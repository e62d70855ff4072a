"""``python -m repro_torch tune`` — search / show / apply kernel autotuning
and the dispatch table (port of ``repro.tune.cli``; same subcommands,
flags and exit codes, plus ``--device``).

* ``search`` — time every candidate config and persist the winner per
  (kernel, shape, dtype, machine, backend); a stored point is a pure hit
  unless ``--force``.  The points are those whose winners something
  reads: the fused kernels at every (shape, dtype) ``--config``'s train
  step launches them at (``--seq``, ``--batch``, ``--layers``,
  ``--attn-impl``; the smoke variant unless ``--full``), the ERT kernels
  through the ceiling searches of ``characterize`` (tuned), the flash and
  SSD spaces only when named with ``--kernel``; ``--shape`` searches one
  kernel at one shape.  ``--smoke`` is the quick preset (small spaces and
  ceiling sizes).
* ``show``   — print the stored winners without running anything (exit 2
  on an empty store).
* ``apply``  — re-time default vs tuned for every stored winner of the
  backend; exit 1 if a winner went stale (slower than the default beyond
  ``--tolerance``).
* ``dispatch {search,show,apply}`` — the site-keyed fused-vs-reference
  dispatch table: ``search`` runs one config's train phases under
  ``fusion="auto"`` and measures every site (a second pass measures
  nothing), ``show`` prints it, ``apply`` re-measures every site and
  exits 1 if a stored winner now loses beyond ``--tolerance``.

Everything runs on the card unless ``--device cpu`` is given: the
backend follows the device (``cuda``: the hand-written kernels; ``torch``:
the plain versions on the host), and the machine key is the card's
datasheet name (``cpu-host`` on the host) unless ``--machine`` names one.

Examples::

    python -m repro_torch tune search --full --seq 2048 --layers 4
    python -m repro_torch tune search --device cpu --smoke --store /tmp/t.json
    python -m repro_torch tune show --store /tmp/t.json
    python -m repro_torch tune dispatch search --config glm4-9b --device cpu
    python -m repro_torch tune dispatch show
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import Sequence

from repro_torch.tune import space as sp
from repro_torch.tune.store import TuneStore

PROG = "python -m repro_torch tune"


def _parse_shape(text: str) -> tuple[int, ...]:
    for sep in ("x", ","):
        if sep in text:
            return tuple(int(p) for p in text.split(sep) if p.strip())
    return (int(text),)


def _context(args) -> tuple[TuneStore, str, object]:
    """(store, machine key, device) of a subcommand; raises RuntimeError
    without a card for ``--device cuda``."""
    from repro_torch.device import resolve_device
    from repro_torch.tune.store import machine_for
    dev = resolve_device(args.device)
    return TuneStore(args.store), args.machine or machine_for(dev), dev


def _backend(args, dev) -> str:
    return args.backend or ("cuda" if dev.type == "cuda" else "torch")


def cmd_search(args) -> int:
    from repro_torch.tune.search import search, tune_workload
    store, machine, dev = _context(args)
    backend = _backend(args, dev)
    known = sp.kernels_for(backend)
    kernels = args.kernel or []
    bad = [k for k in kernels if k not in known]
    if bad:
        print(f"search: no {backend} search space for {', '.join(bad)} "
              f"(valid: {', '.join(known)})", file=sys.stderr)
        return 2
    if args.shape and len(kernels) != 1:
        print("search: --shape needs exactly one --kernel", file=sys.stderr)
        return 2
    try:
        if args.shape:
            print(search(kernels[0], shape=_parse_shape(args.shape),
                         dtype=args.dtype, machine=machine, backend=backend,
                         store=store, iters=args.iters, warmup=args.warmup,
                         smoke=args.smoke, force=args.force).describe())
        else:
            tune_workload(
                kernels, backend=backend, machine=machine, store=store,
                config=args.config, seq=args.seq, batch=args.batch,
                amp=args.amp, full=args.full, n_layers=args.layers,
                attn_impl=args.attn_impl, ceilings=args.ceilings,
                iters=args.iters, warmup=args.warmup, smoke=args.smoke,
                force=args.force, device=dev, progress=print)
    except Exception:
        print("[FAIL] search", file=sys.stderr)
        traceback.print_exc()
        return 1
    print(f"store: {store.path} ({len(list(store.keys()))} winners)")
    return 0


def cmd_show(args) -> int:
    store = TuneStore(args.store)
    recs = store.records()
    if args.kernel:
        recs = [r for r in recs if r.kernel in args.kernel]
    if not recs:
        print(f"show: no tuned records in {store.path}", file=sys.stderr)
        return 2
    hdr = (f"{'kernel':<16} {'be':<6} {'shape':<18} {'dtype':<9} "
           f"{'params':<44} {'wall':>10} {'speedup':>8}  age")
    print(hdr)
    print("-" * len(hdr))
    now = time.time()
    for r in recs:
        params = ",".join(f"{k}={v}" for k, v in sorted(r.params.items()))
        age_h = (now - r.timestamp) / 3600 if r.timestamp else 0.0
        print(f"{r.kernel:<16} {r.backend:<6} "
              f"{'x'.join(map(str, r.shape)):<18} {r.dtype:<9} "
              f"{params or '-':<44} {r.wall_s*1e6:>8.1f}us "
              f"{r.speedup:>7.2f}x  {age_h:.1f}h")
    return 0


def cmd_apply(args) -> int:
    from repro_torch.tune.search import _time_candidate
    store, _, dev = _context(args)
    backend = _backend(args, dev)
    recs = [r for r in store.records() if r.backend == backend]
    if args.kernel:
        recs = [r for r in recs if r.kernel in args.kernel]
    if not recs:
        print(f"apply: no {backend} winners in {store.path}",
              file=sys.stderr)
        return 2
    stale = 0
    for r in recs:
        cands = sp.candidates(r.kernel, r.shape, r.dtype, backend)
        tuned = next((c for c in cands if c.dict == r.params), None)
        default = next((c for c in cands if sp.is_default(
            r.kernel, backend, r.shape, c.dict)), None)
        if tuned is None or default is None:
            print(f"[stale] {r.kernel} {r.shape}: stored params "
                  f"{r.params} no longer in the search space — re-search")
            stale += 1
            continue
        wall_d = _time_candidate(default, args.iters, args.warmup)
        wall_t = (wall_d if tuned.params == default.params
                  else _time_candidate(tuned, args.iters, args.warmup))
        speed = wall_d / wall_t if wall_t else 0.0
        ok = speed >= 1.0 - args.tolerance
        print(f"[{'ok  ' if ok else 'LOST'}] {r.kernel:<16} "
              f"{'x'.join(map(str, r.shape)):<16} "
              f"default {wall_d*1e6:9.1f}us -> tuned {wall_t*1e6:9.1f}us "
              f"({speed:.2f}x)")
        if not ok:
            stale += 1
    return 1 if stale else 0


def cmd_dispatch_search(args) -> int:
    from repro_torch.tune import dispatch as dsp
    store, machine, dev = _context(args)
    try:
        outcome = dsp.search_sites(
            args.config, seq=args.seq, batch=args.batch, amp=args.amp,
            machine=machine, store=store, iters=args.iters,
            warmup=args.warmup, smoke=not args.full, force=args.force,
            n_layers=args.layers, attn_impl=args.attn_impl, device=dev)
    except Exception:
        print("[FAIL] dispatch search", file=sys.stderr)
        traceback.print_exc()
        return 1
    print(outcome.describe())
    print(f"store: {store.path} "
          f"({len(list(store.dispatch_keys()))} dispatch winners)")
    return 0


def cmd_dispatch_show(args) -> int:
    from repro_torch.tune import dispatch as dsp
    recs = dsp.dispatch_table(TuneStore(args.store))
    if not recs:
        print(f"dispatch show: no dispatch records in {args.store}",
              file=sys.stderr)
        return 2
    hdr = (f"{'op':<14} {'shapes':<22} {'dtypes':<18} {'flags':<26} "
           f"{'fused':>10} {'ref':>10} {'winner':<10} {'speedup':>7}")
    print(hdr)
    print("-" * len(hdr))
    for r in recs:
        shapes = ",".join("x".join(map(str, s)) for s in r.shapes)
        flags = ",".join(f"{k}={v}" for k, v in sorted(r.flags.items()))
        print(f"{r.op:<14} {shapes:<22} {','.join(r.dtypes):<18} "
              f"{flags or '-':<26} {r.fused_wall_s*1e6:>8.1f}us "
              f"{r.ref_wall_s*1e6:>8.1f}us {r.impl:<10} "
              f"{r.speedup:>6.2f}x")
    return 0


def cmd_dispatch_apply(args) -> int:
    from repro_torch.tune import dispatch as dsp
    store, _, dev = _context(args)
    recs = dsp.dispatch_table(store)
    if not recs:
        print(f"dispatch apply: no dispatch records in {args.store}",
              file=sys.stderr)
        return 2
    stale = 0
    for old in recs:
        new = dsp.measure_site(old.to_key(), store=store, device=dev,
                               iters=args.iters, warmup=args.warmup)
        walls = {"fused": new.fused_wall_s, "reference": new.ref_wall_s}
        loser = "fused" if old.impl == "reference" else "reference"
        held = walls[old.impl] <= walls[loser] * (1.0 + args.tolerance)
        print(f"[{'ok  ' if held else 'LOST'}] {new.describe()}  "
              f"(was {old.impl})")
        if not held:
            stale += 1
    return 1 if stale else 0


def build_parser(prog: str = PROG) -> argparse.ArgumentParser:
    from repro_torch.configs.base import AMP_MODES, ATTN_IMPLS
    from repro_torch.core.machine import MACHINES
    from repro_torch.tune.store import default_store_path

    ap = argparse.ArgumentParser(
        prog=prog, description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def store(p) -> None:
        p.add_argument("--store", default=default_store_path(),
                       help="tune store path (default: tune.json of the "
                            "workspace: $REPRO_WORKSPACE, else "
                            "./.repro-workspace in a checkout)")

    def device(p) -> None:
        p.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu'")
        p.add_argument("--machine", default=None, choices=sorted(MACHINES),
                       help="machine key the winners are stored under "
                            "(default: the card's datasheet name; cpu-host "
                            "on the host)")

    def kernel(p) -> None:
        p.add_argument("--kernel", action="append",
                       choices=list(sp.CUDA_KERNELS),
                       help="kernel name (repeatable; default: all of the "
                            "backend's)")

    def backend(p) -> None:
        p.add_argument("--backend", default=None, choices=sp.BACKENDS,
                       help="cuda: the hand-written kernels; torch: the "
                            "plain versions on the host (default: the "
                            "device's)")

    def step(p) -> None:
        p.add_argument("--config", default="glm4-9b",
                       help="model config whose train phases to run")
        p.add_argument("--seq", type=int, default=16)
        p.add_argument("--batch", type=int, default=2)
        p.add_argument("--amp", default="O1", choices=AMP_MODES)
        p.add_argument("--layers", type=int, default=None,
                       help="cut the depth (the AdamW leaves follow it)")
        p.add_argument("--attn-impl", default="einsum", choices=ATTN_IMPLS,
                       help="'chunked' adds the flash_attn site where S > "
                            "the chunk")
        p.add_argument("--full", action="store_true",
                       help="the full config, not the smoke variant")

    se = sub.add_parser("search", help="time candidate configs, persist "
                                       "winners (store hit = no re-timing)")
    store(se)
    kernel(se)
    device(se)
    backend(se)
    se.add_argument("--shape", default=None,
                    help="problem shape, e.g. 4096x4096 (needs exactly one "
                         "--kernel; default: the points of --config's "
                         "train step)")
    step(se)
    se.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    se.add_argument("--iters", type=int, default=3)
    se.add_argument("--warmup", type=int, default=1)
    se.add_argument("--smoke", action="store_true",
                    help="quick preset: tiny shapes and spaces, ceilings too")
    se.add_argument("--ceilings", action="store_true",
                    help="also run the ceiling searches")
    se.add_argument("--force", action="store_true",
                    help="re-time even on a store hit")
    se.set_defaults(fn=cmd_search)

    sh = sub.add_parser("show", help="print stored winners, no re-running")
    store(sh)
    kernel(sh)
    sh.set_defaults(fn=cmd_show)

    app = sub.add_parser("apply", help="re-time default vs tuned winners, "
                                       "verify the speedup holds")
    store(app)
    kernel(app)
    device(app)
    backend(app)
    app.add_argument("--iters", type=int, default=3)
    app.add_argument("--warmup", type=int, default=1)
    app.add_argument("--tolerance", type=float, default=0.10,
                     help="allowed tuned-vs-default slowdown before a "
                          "winner counts as stale (default 0.10)")
    app.set_defaults(fn=cmd_apply)

    dp = sub.add_parser("dispatch", help="site-keyed fused-vs-reference "
                                         "dispatch table")
    dsub = dp.add_subparsers(dest="dispatch_cmd", required=True)

    ds = dsub.add_parser("search", help="run one config's train phases "
                                        "under fusion=auto and measure "
                                        "every dispatch site (store hit = "
                                        "no re-timing)")
    store(ds)
    device(ds)
    step(ds)
    ds.add_argument("--iters", type=int, default=3)
    ds.add_argument("--warmup", type=int, default=1)
    ds.add_argument("--force", action="store_true",
                    help="re-measure even on a store hit")
    ds.set_defaults(fn=cmd_dispatch_search)

    dsh = dsub.add_parser("show", help="print the stored dispatch winners")
    store(dsh)
    dsh.set_defaults(fn=cmd_dispatch_show)

    dap = dsub.add_parser("apply", help="re-measure every stored site and "
                                        "verify each winner still wins")
    store(dap)
    device(dap)
    dap.add_argument("--iters", type=int, default=3)
    dap.add_argument("--warmup", type=int, default=1)
    dap.add_argument("--tolerance", type=float, default=0.10,
                     help="allowed winner-vs-loser slowdown before a site "
                          "counts as stale (default 0.10)")
    dap.set_defaults(fn=cmd_dispatch_apply)
    return ap


def main(argv: Sequence[str] | None = None, prog: str = PROG) -> int:
    args = build_parser(prog).parse_args(argv)
    try:
        return args.fn(args)
    except RuntimeError as e:       # no CUDA device for --device cuda
        print(f"{args.cmd}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
