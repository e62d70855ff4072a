"""Run one cell of the port's benchmark and print its result line.

From the root of a checkout::

    python3 perfbench/run.py --workload glm4-9b.train-4k --seed 7 --seconds 20 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's ``end_to_end``
metrics with ``--trace 0``, its ``per_layer`` metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit.  The same numbers
are the last lines of standard error.

It exits with another code than 0, and prints no result, when there is
no CUDA card or fewer than the cell asks for, when the program cannot
be imported, and when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: top-level module names no run may hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (the loaded modules'
    by default), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the bytecode of every module the run imports, cached at a fixed path
    # in the checkout: only a checkout's first run compiles the sources
    # (the lazy imports of the first train step are half of its time
    # where the installation keeps no bytecode)
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from perfbench import bench
    cell = bench.Cell.load(args.workload, ROOT)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        return _fail(f"{args.workload} needs {need} CUDA device(s); "
                     f"found {torch.cuda.device_count()}", 3)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program is not importable: {e}", 4)

    # the program reads tuned launch configs from a workspace: an empty
    # one of this run's own, so every launch takes its default config
    ws = tempfile.mkdtemp(prefix="perfbench-ws-")
    os.environ["REPRO_WORKSPACE"] = ws
    try:
        result = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t0=T0)
    finally:
        shutil.rmtree(ws, ignore_errors=True)

    found = forbidden_modules()
    if found:
        return _fail(f"the run loaded {', '.join(found)}", 5)
    for name, value in result.pop("readings").items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
