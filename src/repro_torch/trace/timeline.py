"""Per-phase timeline + overlap model against the three-term envelope
(port of ``repro.trace.timeline``).

Each measured phase carries its analytical envelope from
``repro_torch.core.roofline``::

    bound_overlap_s = max(T_compute, T_memory, T_collective)   (perfect overlap)
    bound_serial_s  = T_compute + T_memory + T_collective      (no overlap)

A measured wall time landing inside ``[overlap, serial]`` tells you how
much overlap the runtime actually achieved (1.0 = perfect, 0.0 = fully
serialized); outside the envelope it tells you the machine model is wrong
for this host (``sub-bound``) or that non-roofline overhead dominates
(``overhead``).  The timeline lays phases out sequentially — a training
step *is* fwd → bwd → opt — and renders a text gantt with the envelope
tick marks on every bar.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.trace.collector import PhaseMeasurement


@dataclasses.dataclass(frozen=True)
class PhaseSpan:
    """One phase placed on the step timeline."""

    name: str
    start_s: float
    measured_s: float
    bound_overlap_s: float
    bound_serial_s: float
    dominant: str

    @property
    def end_s(self) -> float:
        return self.start_s + self.measured_s

    @property
    def overlap_efficiency(self) -> float:
        """Where the measurement lands inside the envelope.

        1.0 = at the perfect-overlap bound, 0.0 = fully serialized (or
        worse); clamped so out-of-envelope measurements stay readable.
        """
        lo, hi = self.bound_overlap_s, self.bound_serial_s
        if self.measured_s <= lo:
            return 1.0
        if hi <= lo or self.measured_s >= hi:
            return 0.0
        return (hi - self.measured_s) / (hi - lo)

    @property
    def verdict(self) -> str:
        if self.measured_s < self.bound_overlap_s:
            return "sub-bound"          # machine model underestimates host
        if self.measured_s <= self.bound_serial_s:
            return "overlapped"
        if self.measured_s <= 2 * self.bound_serial_s:
            return "serial"
        return "overhead"               # way past even the no-overlap bound


@dataclasses.dataclass
class Timeline:
    spans: list[PhaseSpan]

    @property
    def total_measured_s(self) -> float:
        return sum(s.measured_s for s in self.spans)

    @property
    def total_bound_overlap_s(self) -> float:
        return sum(s.bound_overlap_s for s in self.spans)

    @property
    def total_bound_serial_s(self) -> float:
        return sum(s.bound_serial_s for s in self.spans)

    @property
    def pct_of_roofline(self) -> float:
        t = self.total_measured_s
        return self.total_bound_overlap_s / t if t else 0.0


def build_timeline(measurements: Mapping[str, PhaseMeasurement]) -> Timeline:
    """Sequential layout in mapping order (fwd → bwd → opt)."""
    spans: list[PhaseSpan] = []
    t = 0.0
    for name, m in measurements.items():
        spans.append(PhaseSpan(
            name=name, start_s=t, measured_s=m.wall_s,
            bound_overlap_s=m.bound_overlap_s,
            bound_serial_s=m.bound_serial_s,
            dominant=m.dominant))
        t += m.wall_s
    return Timeline(spans)


def timeline_from_record(rec) -> Timeline:
    """Timeline from a stored :class:`~repro_torch.trace.store.TraceRecord`
    (or anything with a ``.phases`` mapping of metric payloads)."""
    spans: list[PhaseSpan] = []
    t = 0.0
    for name, p in rec.phases.items():
        wall = float(p.get("wall_s", 0.0))
        spans.append(PhaseSpan(
            name=name, start_s=t, measured_s=wall,
            bound_overlap_s=float(p.get("bound_overlap_s", 0.0)),
            bound_serial_s=float(p.get("bound_serial_s", 0.0)),
            dominant=str(p.get("dominant", ""))))
        t += wall
    return Timeline(spans)


def ascii_timeline(tl: Timeline, width: int = 60) -> str:
    """Text gantt: one bar per phase, ``|`` = perfect-overlap bound,
    ``:`` = serial bound, scaled to the whole measured step."""
    total = tl.total_measured_s or 1.0
    scale = width / total
    out = [f"{'phase':<12}{'measured':>11}{'bound[ov,ser]':>18}"
           f"{'overlap':>9}  verdict"]
    for s in tl.spans:
        out.append(
            f"{s.name[:11]:<12}{s.measured_s*1e3:>9.3f}ms"
            f"{s.bound_overlap_s*1e3:>8.3f}/{s.bound_serial_s*1e3:<8.3f}"
            f"{100*s.overlap_efficiency:>8.1f}%  {s.verdict}")
    out.append("")
    for s in tl.spans:
        off = int(s.start_s * scale)
        bar = max(1, int(s.measured_s * scale))
        line = [" "] * (off) + ["#"] * bar
        for mark, t_mark in (("|", s.start_s + s.bound_overlap_s),
                             (":", s.start_s + s.bound_serial_s)):
            x = int(t_mark * scale)
            if x < len(line):
                line[x] = mark
            elif x == len(line):
                line.append(mark)
        out.append(f"{s.name[:11]:<12}" + "".join(line))
    out.append(f"{'':<12}0 {'-'*(width-10)} {total*1e3:.3f} ms")
    out.append(f"{'':<12}# measured  | perfect-overlap bound  : serial bound")
    out.append(
        f"step: {tl.total_measured_s*1e3:.3f} ms measured vs "
        f"[{tl.total_bound_overlap_s*1e3:.3f}, "
        f"{tl.total_bound_serial_s*1e3:.3f}] ms bound | "
        f"{100*tl.pct_of_roofline:.1f}% of roofline")
    return "\n".join(out)
