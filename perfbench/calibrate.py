"""Read the numbers that set a cell's limits, on the chip at the cell's own
size: the program's sound runs, the control (the reference with float8
compute in the program's place), the planted faults and the witness
(the reference in bfloat16), each against the float32 reference from
the same weights and batches.

From the root of a checkout::

    python3 perfbench/calibrate.py --workload glm4-9b.train-4k \\
        --seeds 1000-1011 --kinds program,control,half_batch \\
        --out cal.jsonl

``--seeds`` takes ranges and lists (``1000-1011,2000``); every kind in
``--kinds`` is read on every seed.  Kinds: ``program``, ``control``
(float8), ``witness`` (bfloat16 values), ``witness_bwd`` (bfloat16
values and gradients), and each fault of
:func:`perfbench.faults.of_family`.  One JSON object a reading goes to
``--out`` (one per line) and to standard output, with every number of
:mod:`perfbench.check` and each leaf's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the kinds that are the reference in another precision
PRECISION = {"control": "fp8", "witness": "bf16", "witness_bwd": "bf16bwd"}


def seeds_of(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program,control,half_batch")
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", default=[],
                    help="key=value over the configuration's run settings "
                         "of the program (a look at a cause, e.g. amp=O0)")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from perfbench import bench, check, faults
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    os.environ["REPRO_WORKSPACE"] = tempfile.mkdtemp(prefix="perfbench-ws-")
    cell = bench.Cell.load(args.workload, ROOT)
    for kv in args.run:
        key, value = kv.split("=", 1)
        cell.config["run"][key] = value
    dev = torch.device("cuda")
    kinds = args.kinds.split(",")

    def program(seed):
        prog = bench.Program(cell, seed, dev)
        try:
            return prog.follow()
        finally:
            prog.close()

    def reading(kind, seed):
        if kind == "program":
            return program(seed)
        if kind in PRECISION:
            return bench.reference(cell, seed, dev,
                                   precision=PRECISION[kind])
        with faults.of_family(cell.family)[kind]():
            return program(seed)

    with open(args.out, "w") as out:
        for seed in seeds_of(args.seeds):
            t = time.perf_counter()
            ref = bench.reference(cell, seed, dev)
            torch.cuda.synchronize()
            t_ref = time.perf_counter() - t
            for kind in kinds:
                t = time.perf_counter()
                mine = reading(kind, seed)
                nums, where = check.numbers(mine, ref)
                row = {"workload": args.workload, "kind": kind, "seed": seed,
                       "run": args.run, **nums, "where": where,
                       "seconds": {"reading": time.perf_counter() - t,
                                   "reference": t_ref},
                       "leaves": check.leaf_numbers(mine, ref),
                       "losses": mine.losses, "ref_losses": ref.losses}
                line = json.dumps(row)
                print(line, flush=True)
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
