"""Benchmark driver (port of ``benchmarks/run.py``): one suite per paper
table or figure, plus the train-throughput check.

``python -m repro_torch.bench [--list] [--only a,b] [--device cpu]
[--full]`` prints ``name,us_per_call,derived`` CSV rows and exits 1 if
any suite raised.  Each run writes ``BENCH_<utc timestamp>.json`` (suite
→ rows and wall seconds, with the git SHA, the host and the device) under
the port workspace's ``bench/`` directory (``REPRO_WORKSPACE``, else
``./.repro-workspace`` in a checkout, else ``~/.repro``) and nowhere
else; ``--json-dir ''`` writes none.  ``--full`` runs the census and the
DeepCAM roofline at the paper's resolution (width 64, 768×1152); they
walk meta tensors, so the host can too.  The device is the card unless
``--device cpu`` asks for the host, where the measuring suites time the
plain versions at smoke sizes.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
import traceback

SUITES = (
    "ert_ceilings",      # paper Fig 1
    "ert_ladder",        # paper Table I
    "gemm_sweep",        # paper Fig 2 / Eq 3
    "deepcam_roofline",  # paper Figs 3-7
    "amp_study",         # paper Figs 8-9, §IV-C
    "zero_ai_census",    # paper Table III (+ the LM off-against-static)
    "train_throughput",  # operational: measured smoke train steps
)
#: suites that take ``full`` (the paper's DeepCAM resolution)
FULL_SUITES = ("deepcam_roofline", "zero_ai_census")


def default_json_dir() -> str:
    from repro_torch.session.workspace import Workspace
    return Workspace().bench_dir


def run(names, device: str = "cuda", full: bool = False,
        echo: bool = False) -> dict[str, dict]:
    """{suite: {"ok", "wall_s", "rows"}} of each suite in ``names``, in
    ``SUITES`` order; a suite that raises is ``ok: False`` with no rows
    and its traceback printed.  ``echo`` prints each suite's rows as it
    ends."""
    from repro_torch.bench.common import emit
    results: dict[str, dict] = {}
    for name in SUITES:
        if name not in names:
            continue
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        kw = {"full": True} if full and name in FULL_SUITES else {}
        t0 = time.time()
        try:
            rows = mod.main(device, **kw)
        except Exception:
            print(f"{name},0.0,ERROR")
            traceback.print_exc()
            results[name] = {"ok": False, "wall_s": time.time() - t0,
                             "rows": []}
            continue
        results[name] = {"ok": True, "wall_s": time.time() - t0,
                         "rows": rows}
        if echo:
            emit(rows)
            print(f"# {name}: {len(rows)} rows in "
                  f"{results[name]['wall_s']:.1f}s", file=sys.stderr)
    return results


def write_json(json_dir: str, results: dict[str, dict], device: str) -> str:
    """Persist one run's rows as ``BENCH_<utc timestamp>.json``."""
    import torch

    from repro_torch.trace.store import git_sha, host_fingerprint
    os.makedirs(json_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    path = os.path.join(json_dir, f"BENCH_{stamp}.json")
    dev = torch.device(device)
    doc = {
        "schema_version": 1,
        "timestamp": time.time(),
        "git_sha": git_sha(),
        "host": host_fingerprint(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "suites": {
            name: {"ok": r["ok"], "wall_s": r["wall_s"],
                   "rows": [{"name": n, "us_per_call": us, "derived": d}
                            for n, us, d in r["rows"]]}
            for name, r in results.items()},
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--list", action="store_true",
                    help="print the suite names and exit")
    ap.add_argument("--only", default=None, metavar="A,B",
                    help="comma-separated suites to run (see --list)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--full", action="store_true",
                    help="the census and the DeepCAM roofline at width 64 "
                         "on 768x1152 images")
    ap.add_argument("--json-dir", default=None,
                    help="where BENCH_<timestamp>.json lands (default: the "
                         "workspace's bench/; '' writes none)")
    args = ap.parse_args(argv)
    if args.list:
        for name in SUITES:
            print(name)
        return 0
    names = SUITES if args.only is None else tuple(args.only.split(","))
    unknown = [n for n in names if n not in SUITES]
    if unknown:
        print(f"repro_torch.bench: unknown suite(s) {unknown}; valid: "
              f"{', '.join(SUITES)}", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:            # no CUDA device for --device cuda
        print(f"repro_torch.bench: {e}", file=sys.stderr)
        return 2
    results = run(names, args.device, args.full, echo=True)
    json_dir = default_json_dir() if args.json_dir is None else args.json_dir
    if json_dir and results:
        path = write_json(json_dir, results, args.device)
        print(f"# results -> {path}", file=sys.stderr)
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
