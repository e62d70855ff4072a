"""Cross-run regression detection over the trace store (port of
``repro.trace.compare``).

``compare_records`` diffs two :class:`~repro_torch.trace.store.TraceRecord`\\ s
cell by cell — a *cell* is (phase × metric) — and flags any move past a
relative threshold in the bad direction (wall time up, achieved FLOP/s or
%-of-roofline down).  ``compare_last`` wires that to the store's history
so CI can run ``record`` then ``compare`` on every commit and fail the
build when a config gets slower.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.trace.store import TraceRecord, TraceStore

# metric -> +1 (higher is worse) / -1 (lower is worse)
DEFAULT_METRICS: dict[str, int] = {
    "wall_s": +1,
    "achieved_flops_per_s": -1,
    "pct_of_roofline": -1,
}


@dataclasses.dataclass(frozen=True)
class CellDelta:
    """One (config × phase × metric) comparison between two runs."""

    config: str
    phase: str
    metric: str
    base: float
    new: float
    direction: int                  # +1 higher-is-worse, -1 lower-is-worse
    threshold: float
    base_run: str
    new_run: str

    @property
    def rel_delta(self) -> float:
        """Signed relative change, positive = got worse."""
        if self.base == 0:
            return 0.0 if self.new == 0 else float("inf") * self.direction
        return self.direction * (self.new - self.base) / abs(self.base)

    @property
    def regression(self) -> bool:
        return self.rel_delta > self.threshold

    @property
    def improvement(self) -> bool:
        return self.rel_delta < -self.threshold


def compare_records(base: TraceRecord, new: TraceRecord,
                    threshold: float = 0.10,
                    metrics: Mapping[str, int] | None = None
                    ) -> list[CellDelta]:
    """Per-cell deltas for every phase the two runs share.

    Phases present in only one run are reported as a ``wall_s`` cell with
    the missing side at 0 — a vanished or new phase is itself a signal.
    """
    metrics = dict(metrics or DEFAULT_METRICS)
    out: list[CellDelta] = []
    shared = [p for p in base.phases if p in new.phases]
    for phase in shared:
        b, n = base.phases[phase], new.phases[phase]
        for metric, direction in metrics.items():
            if metric not in b or metric not in n:
                continue
            out.append(CellDelta(
                config=new.config or base.config, phase=phase,
                metric=metric, base=float(b[metric]), new=float(n[metric]),
                direction=direction, threshold=threshold,
                base_run=base.run_id, new_run=new.run_id))
    for phase in base.phases:
        if phase not in new.phases:
            # direction=-1: the drop from base to 0 must read as a
            # regression (a silently dropped phase passing CI is the exact
            # failure mode this gate exists for)
            out.append(CellDelta(
                config=base.config, phase=phase, metric="wall_s",
                base=float(base.phases[phase].get("wall_s", 0.0)), new=0.0,
                direction=-1, threshold=threshold,
                base_run=base.run_id, new_run=new.run_id))
    for phase in new.phases:
        if phase not in base.phases:
            out.append(CellDelta(
                config=new.config, phase=phase, metric="wall_s",
                base=0.0, new=float(new.phases[phase].get("wall_s", 0.0)),
                direction=+1, threshold=threshold,
                base_run=base.run_id, new_run=new.run_id))
    return out


def compare_last(store: TraceStore, config: str | None = None,
                 threshold: float = 0.10, window: int = 2
                 ) -> list[CellDelta]:
    """Compare the newest run of each config against the run ``window - 1``
    records earlier (default: the previous one).

    Runs are grouped by (config, fusion mode): a ``fusion="auto"`` trace
    is a different lowering, not a regression or an improvement of the
    reference one — interleaved before/after records (the documented
    ``record`` / ``record --fusion auto`` pair) must never be diffed
    against each other.
    """
    groups: dict[tuple[str, str], list[TraceRecord]] = {}
    for rec in store.records(config):       # one pass over the store
        key = (rec.config, str(rec.meta.get("fusion", "off")))
        groups.setdefault(key, []).append(rec)
    out: list[CellDelta] = []
    for recs in groups.values():
        recs = recs[-window:]
        if len(recs) < 2:
            continue
        out.extend(compare_records(recs[0], recs[-1], threshold))
    return out


def regressions(deltas: Sequence[CellDelta]) -> list[CellDelta]:
    return [d for d in deltas if d.regression]


def has_regressions(deltas: Sequence[CellDelta]) -> bool:
    return any(d.regression for d in deltas)


def format_deltas(deltas: Sequence[CellDelta],
                  only_flagged: bool = False) -> str:
    """Terminal table, one row per cell; ``!`` = regression, ``+`` =
    improvement past the threshold."""
    rows = [d for d in deltas if not only_flagged
            or d.regression or d.improvement]
    if not rows:
        return "no cells to compare (need >= 2 runs per config)"
    out = [f"{'config':<24}{'phase':<12}{'metric':<22}{'base':>12}"
           f"{'new':>12}{'delta':>9}  flag"]
    for d in rows:
        rel = d.rel_delta
        flag = "!" if d.regression else ("+" if d.improvement else "")
        rel_s = "inf" if rel == float("inf") else f"{100*rel:+.1f}%"
        out.append(
            f"{d.config[:23]:<24}{d.phase[:11]:<12}{d.metric:<22}"
            f"{_fmt(d.base):>12}{_fmt(d.new):>12}{rel_s:>9}  {flag}")
    n_reg = sum(1 for d in rows if d.regression)
    n_imp = sum(1 for d in rows if d.improvement)
    out.append(f"{len(rows)} cells | {n_reg} regression(s) "
               f"| {n_imp} improvement(s) "
               f"(threshold {100*rows[0].threshold:.0f}%, "
               "delta sign: positive = worse)")
    return "\n".join(out)


def _fmt(x: float) -> str:
    if x == 0:
        return "0"
    if abs(x) >= 1e9:
        return f"{x/1e9:.2f}G"
    if abs(x) >= 1e6:
        return f"{x/1e6:.2f}M"
    if abs(x) >= 1e3:
        return f"{x/1e3:.2f}K"
    if abs(x) < 0.1:
        return f"{x*1e3:.3f}m"
    return f"{x:.3f}"
