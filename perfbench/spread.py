"""The spread of each end-to-end metric over sets of runs of one cell, as
the bounds of ``BENCHMARK.json`` are set from it.

Each argument is a file of result lines (the last line of each run's
standard output, one a line), one file a set::

    python3 perfbench/spread.py set1.jsonl set2.jsonl

For each metric it prints each set's median and spread (the distance
between the first and third quartile of ``statistics.quantiles(values,
n=4)`` over the median), the wider spread, five times it, and the
second set's median against the first's.
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values: list[float]) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(paths: list[str]) -> int:
    sets = []
    for path in paths:
        with open(path) as f:
            sets.append([json.loads(line) for line in f if line.strip()])
    names = sorted({m for rows in sets for r in rows for m in r["metrics"]})
    for name in names:
        per = [[r["metrics"][name]["value"] for r in rows
                if name in r["metrics"]] for rows in sets]
        meds = [statistics.median(v) for v in per]
        spreads = [spread(v) for v in per if len(v) >= 2]
        wide = max(spreads) if spreads else float("nan")
        print(f"{name}: medians {meds} spreads {spreads} widest {wide:.5f}"
              f" 5x {5 * wide:.5f} second/first {meds[-1] / meds[0]:.5f}")
    print("correct:", [sum(r["correct"] for r in rows) for rows in sets],
          "of", [len(rows) for rows in sets])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
