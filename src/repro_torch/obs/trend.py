"""Perf-trend tracking: time series over the workspace's stored history
(port of ``repro.obs.trend``).

Two sources, one series shape:

* **Trace records** (``trace.jsonl`` and ``sweep.jsonl``): per
  ``(config, machine, host, fusion)`` key, series of step wall time,
  achieved GFLOP/s, %-of-roofline and each memory level's bound fraction
  (``hbm`` / ``vmem`` — the on-chip level, L2 on Hopper — streaming time
  over the measured wall);
* **Bench harvests** (``bench/BENCH_*.json`` of ``python -m
  repro_torch.bench``): each suite's wall seconds and each row's
  ``us_per_call``, keyed by the host fingerprint the file stamps.

A series is drawn as an ASCII sparkline (oldest → newest) and gated:
``gate_series`` flags a lower-is-better series whose newest point exceeds
the median of its recent history (or a pinned run's value) by more than
the tolerance.  The exit codes belong to the CLI (``python -m
repro_torch trend --gate``).

The harvests are read from the workspace's ``bench/`` and the directories
passed in, nowhere else: the port never wrote ``benchmarks/results`` or
the repository root, and a harvest of the JAX package's host run is not
the card's.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import statistics
from typing import Any, Iterable

#: sparkline glyphs, low → high
_SPARK = "▁▂▃▄▅▆▇█"

#: how many trailing points (the newest excluded) form the gate's baseline
BASELINE_WINDOW = 5

#: default relative tolerance of the regression gate
DEFAULT_TOLERANCE = 0.25


@dataclasses.dataclass(frozen=True)
class TrendPoint:
    timestamp: float
    value: float
    ref: str                      # run id / harvest file: the evidence


@dataclasses.dataclass
class TrendSeries:
    """One metric's history under one key, oldest first."""

    key: str                      # e.g. "glm4-9b|h100-sxm|hostA|off"
    source: str                   # "trace" | "bench"
    metric: str                   # "wall_s" | "gflops" | "us_per_call" | ...
    lower_is_better: bool
    points: list[TrendPoint] = dataclasses.field(default_factory=list)

    @property
    def values(self) -> list[float]:
        return [p.value for p in self.points]

    @property
    def newest(self) -> TrendPoint:
        return self.points[-1]

    def baseline(self) -> float | None:
        """Median of the recent history *before* the newest point."""
        prior = self.values[:-1][-BASELINE_WINDOW:]
        return statistics.median(prior) if prior else None


def sparkline(values: Iterable[float]) -> str:
    vals = list(values)
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[3] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / span * (len(_SPARK) - 1) + 0.5))]
        for v in vals)


# --------------------------------------------------------------------------
# trace-store series
# --------------------------------------------------------------------------

def _trace_key(rec: Any) -> str:
    host = rec.host.get("host", "?") if isinstance(rec.host, dict) else "?"
    fusion = str(rec.meta.get("fusion", "off"))
    return f"{rec.config}|{rec.machine}|{host}|{fusion}"


def trace_series(records: Iterable[Any]) -> list[TrendSeries]:
    """Series of trace and sweep records: wall, achieved GFLOP/s,
    %-of-roofline and each level's bound fraction per key.  Only measured
    records (wall > 0) count: an analytical payload has no time to
    trend."""
    from repro_torch.sweep.aggregate import summary_row

    metrics = (("wall_s", True), ("gflops", False),
               ("pct_of_roofline", False), ("hbm_frac", False),
               ("vmem_frac", False))
    by_key: dict[tuple[str, str], TrendSeries] = {}
    for rec in sorted(records, key=lambda r: r.timestamp):
        row = summary_row(rec)
        if not row["measured"]:
            continue
        key = _trace_key(rec)
        vals = {"wall_s": row["wall_s"],
                "gflops": row["achieved_flops_per_s"] / 1e9,
                "pct_of_roofline": row["pct_of_roofline"],
                "hbm_frac": row["hbm_frac"],
                "vmem_frac": row["vmem_frac"]}
        for metric, lower in metrics:
            s = by_key.setdefault((key, metric), TrendSeries(
                key=key, source="trace", metric=metric,
                lower_is_better=lower))
            s.points.append(TrendPoint(rec.timestamp, vals[metric],
                                       ref=f"run {rec.run_id}"))
    return list(by_key.values())


# --------------------------------------------------------------------------
# BENCH_*.json series
# --------------------------------------------------------------------------

def bench_files(dirs: Iterable[str]) -> list[str]:
    out: list[str] = []
    for d in dirs:
        if d and os.path.isdir(d):
            out.extend(glob.glob(os.path.join(d, "BENCH_*.json")))
    # the UTC-stamped name sorts by time; a merged copy counts once
    seen: dict[str, str] = {}
    for p in sorted(out, key=os.path.basename):
        seen.setdefault(os.path.basename(p), p)
    return list(seen.values())


def load_bench(path: str) -> dict[str, Any] | None:
    """One harvest file, or ``None`` when unreadable (never fatal)."""
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) and "suites" in doc else None
    except (OSError, ValueError):
        return None


def bench_series(dirs: Iterable[str]) -> list[TrendSeries]:
    """Per-suite wall and per-row ``us_per_call`` series across harvest
    files, keyed by the stamped host (``unknown`` when a file has none)."""
    by_key: dict[tuple[str, str], TrendSeries] = {}
    for path in bench_files(dirs):
        doc = load_bench(path)
        if doc is None:
            continue
        ts = float(doc.get("timestamp", 0.0))
        host = doc.get("host", {}).get("host", "unknown") \
            if isinstance(doc.get("host"), dict) else "unknown"
        ref = os.path.basename(path)
        for suite, s in doc.get("suites", {}).items():
            if not isinstance(s, dict) or not s.get("ok", False):
                continue
            key = f"{suite}|{host}"
            series = by_key.setdefault((key, "wall_s"), TrendSeries(
                key=key, source="bench", metric="wall_s",
                lower_is_better=True))
            series.points.append(TrendPoint(ts, float(s.get("wall_s", 0.0)),
                                            ref=ref))
            for row in s.get("rows", ()):
                us = float(row.get("us_per_call", 0.0))
                if us <= 0:
                    continue                 # a derived-only row: no time
                rkey = f"{suite}/{row.get('name', '?')}|{host}"
                rs = by_key.setdefault((rkey, "us_per_call"), TrendSeries(
                    key=rkey, source="bench", metric="us_per_call",
                    lower_is_better=True))
                rs.points.append(TrendPoint(ts, us, ref=ref))
    return list(by_key.values())


# --------------------------------------------------------------------------
# collection, gate, rendering
# --------------------------------------------------------------------------

def default_bench_dirs(workspace: Any,
                       extra: Iterable[str] = ()) -> list[str]:
    """The harvest directories: the workspace's ``bench/`` and the ones
    passed in."""
    return [workspace.bench_dir, *extra]


def collect_series(workspace: Any, config: str | None = None,
                   bench_dirs: Iterable[str] | None = None
                   ) -> list[TrendSeries]:
    """Every trend series the workspace holds, trace and bench (the
    harvests of its ``bench/`` and of ``bench_dirs``)."""
    recs = list(workspace.trace_store.records(config))
    sweep_recs = workspace.sweep_store.records(config)
    out = trace_series(recs + sweep_recs)
    if config is None:
        out += bench_series(default_bench_dirs(workspace, bench_dirs or ()))
    out.sort(key=lambda s: (s.source, s.key, s.metric))
    return out


@dataclasses.dataclass(frozen=True)
class Regression:
    series: TrendSeries
    baseline: float
    rel: float                    # newest / baseline - 1 (positive: slower)
    baseline_ref: str = ""        # the pinned anchor ("": rolling median)

    def describe(self) -> str:
        s = self.series
        anchor = (f"pinned {self.baseline_ref}" if self.baseline_ref
                  else "baseline")
        return (f"{s.key} [{s.metric}]: {s.newest.value:.6g} vs {anchor} "
                f"{self.baseline:.6g} (+{100 * self.rel:.1f}%, "
                f"{s.newest.ref})")


def pinned_baseline(series: TrendSeries, run_id: str) -> TrendPoint | None:
    """The point of ``series`` that ``run_id`` wrote (a prefix matches, as
    ``TraceStore.run`` does); ``None`` when the series never saw it."""
    want = f"run {run_id}"
    for p in series.points:
        if p.ref == want or p.ref.startswith(want):
            return p
    return None


def gate_series(series: Iterable[TrendSeries],
                tolerance: float = DEFAULT_TOLERANCE,
                baseline_run: str | None = None) -> list[Regression]:
    """Lower-is-better series whose newest point regressed past the
    tolerance against their baseline: the median of the recent history
    (:data:`BASELINE_WINDOW`), or with ``baseline_run`` the value a
    tagged known-good run wrote — then a slowly drifting median cannot
    hide a regression, and a series that never saw that run (bench
    harvests, configs added later) is skipped rather than misjudged."""
    flags: list[Regression] = []
    for s in series:
        if not s.lower_is_better or len(s.points) < 2:
            continue
        ref = ""
        if baseline_run is not None:
            pin = pinned_baseline(s, baseline_run)
            if pin is None or pin is s.newest:
                continue
            base, ref = pin.value, pin.ref
        else:
            base = s.baseline()
        if base is None or base <= 0:
            continue
        rel = s.newest.value / base - 1.0
        if rel > tolerance:
            flags.append(Regression(series=s, baseline=base, rel=rel,
                                    baseline_ref=ref))
    flags.sort(key=lambda r: -r.rel)
    return flags


def _fmt_value(s: TrendSeries) -> str:
    v = s.newest.value
    if s.metric == "wall_s":
        return f"{v * 1e3:.3f}ms"
    if s.metric == "us_per_call":
        return f"{v:.1f}us"
    if s.metric in ("pct_of_roofline", "hbm_frac", "vmem_frac"):
        return f"{100 * v:.1f}%"
    return f"{v:.3g}"


def render_trend(series: list[TrendSeries],
                 regressions: list[Regression] | None = None,
                 max_rows: int = 40) -> str:
    """The trend report: one sparkline row per series, and (when gated)
    the regressions at the bottom."""
    if not series:
        return ("trend: no history yet — run `python -m repro_torch "
                "record` / `python -m repro_torch.bench` into this "
                "workspace first")
    flagged = {id(r.series) for r in (regressions or [])}
    lines = [f"{'series':<52}{'metric':<16}{'n':>3}  "
             f"{'newest':>10}  trend"]
    shown = 0
    for s in series:
        if shown >= max_rows:
            lines.append(f"... {len(series) - shown} more series "
                         "(raise --max-rows)")
            break
        mark = "!" if id(s) in flagged else " "
        lines.append(f"{s.key[:51]:<52}{s.metric:<16}{len(s.points):>3}  "
                     f"{_fmt_value(s):>10}  {sparkline(s.values)}{mark}")
        shown += 1
    if regressions is None:
        return "\n".join(lines)
    if regressions:
        lines.append("")
        lines.append(f"gate: {len(regressions)} regression(s) past "
                     "tolerance:")
        lines += [f"  ! {r.describe()}" for r in regressions]
    else:
        gated = sum(1 for s in series
                    if s.lower_is_better and len(s.points) >= 2)
        lines.append("")
        lines.append(f"gate: OK ({gated} series with history, "
                     "0 regressions)")
    return "\n".join(lines)
