"""Reporting (port of ``repro.core.report``): the paper's figures and
tables as text.  Level marks and ceiling characters are keyed by the
machine's own level names (``l``/``L`` = L2 on Hopper, ``v``/``V`` = VMEM
on the TPU; ``h``/``H`` = HBM on both), so a spec with the reference's
levels renders exactly as the reference does.
"""

from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.machine import MachineSpec
from repro_torch.core.op_analysis import KernelRecord, ModuleAnalysis
from repro_torch.core.roofline import kernel_points


def _fmt_si(x: float, unit: str = "") -> str:
    if x == 0:
        return f"0 {unit}"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= scale:
            return f"{x/scale:.2f} {suffix}{unit}"
    return f"{x:.2f} {unit}"


def _mark(level: str) -> str:
    return level[0].lower()


def _ceiling_char(machine: MachineSpec, level: str) -> str:
    return "-" if level == machine.hbm.name else "."


def ascii_roofline(records: Sequence[KernelRecord], machine: MachineSpec,
                   width: int = 78, height: int = 24,
                   ai_range: tuple[float, float] = (2**-6, 2**14),
                   title: str = "",
                   achieved: Sequence[tuple[float, float]] | None = None
                   ) -> str:
    """Render a hierarchical roofline chart as text (paper Figs 3-9)."""
    lo, hi = (math.log2(a) for a in ai_range)
    peak_top = max(machine.peak_flops.values())
    f_hi = math.log2(peak_top * 2)
    f_lo = f_hi - height * (hi - lo) / width * 1.2

    grid = [[" "] * width for _ in range(height)]

    def put(ai: float, flops_s: float, ch: str) -> None:
        if ai <= 0 or flops_s <= 0:
            return
        x = int((math.log2(ai) - lo) / (hi - lo) * (width - 1))
        y = int((f_hi - math.log2(flops_s)) / (f_hi - f_lo) * (height - 1))
        if 0 <= x < width and 0 <= y < height:
            if grid[y][x] in (" ", ".", "-", "_", "~", "="):
                grid[y][x] = ch

    for level in machine.mem_levels:
        ch = _ceiling_char(machine, level.name)
        for xi in range(width):
            ai = 2 ** (lo + xi * (hi - lo) / (width - 1))
            put(ai, ai * level.bytes_per_s, ch)
    for level in machine.interconnect:
        for xi in range(width):
            ai = 2 ** (lo + xi * (hi - lo) / (width - 1))
            put(ai, ai * level.bytes_per_s, "~" if level.name == "ici" else "=")
    for cls, peak in machine.peak_flops.items():
        for xi in range(width):
            ai = 2 ** (lo + xi * (hi - lo) / (width - 1))
            if ai * machine.hbm.bytes_per_s >= peak * 0.7:
                put(ai, peak, "_")

    pts = []
    for rec in records:
        if rec.flops <= 0:
            continue
        pts.extend((p, rec) for p in kernel_points(rec, machine))
    if pts:
        tmax = max(p.time_bound_s * r.exec_count for p, r in pts) or 1.0
        for p, r in pts:
            ch = _mark(p.level)
            if p.time_bound_s * r.exec_count > 0.25 * tmax:
                ch = ch.upper()
            put(p.ai, p.bound_flops_per_s, ch)

    for ai, flops_s in (achieved or ()):
        put(ai, flops_s, "*")

    lines = [f"  {title}  [{machine.name}"
             f"{' empirical' if machine.empirical else ''}]  "
             f"y: FLOP/s (log2, top={_fmt_si(peak_top, 'FLOP/s')}), "
             f"x: AI (log2 FLOPs/byte)"]
    for yi, row in enumerate(grid):
        f_val = 2 ** (f_hi - yi * (f_hi - f_lo) / (height - 1))
        label = _fmt_si(f_val) if yi % 4 == 0 else ""
        lines.append(f"{label:>10} |{''.join(row)}")
    axis = [" "] * width
    for xi in range(0, width, 13):
        ai = 2 ** (lo + xi * (hi - lo) / (width - 1))
        s = f"{ai:.3g}"
        for j, c in enumerate(s):
            if xi + j < width:
                axis[xi + j] = c
    lines.append(f"{'':>10} +{'-'*width}")
    lines.append(f"{'AI=':>10}  {''.join(axis)}")
    levels = list(reversed(machine.mem_levels))
    markers = " ".join(f"{_mark(lv.name)}/{_mark(lv.name).upper()}="
                       f"{lv.name.upper()}" for lv in levels)
    ceilings = " ".join(f"{_ceiling_char(machine, lv.name)}={lv.name.upper()}"
                        for lv in levels)
    legend = (f"{'':>10}  markers: {markers} (upper=hot) | "
              f"ceilings: _=compute {ceilings} ~=ICI ==DCN")
    if achieved:
        legend += " | *=achieved"
    lines.append(legend)
    return "\n".join(lines)


def kernel_table(analysis: ModuleAnalysis, machine: MachineSpec,
                 top_n: int = 12) -> str:
    rows = []
    for rec in analysis.kernels:
        pts = kernel_points(rec, machine)
        hbm = next(p for p in pts if p.level == machine.hbm.name)
        t = hbm.time_bound_s * rec.exec_count
        t_mem = rec.total_hbm_bytes / machine.hbm.bytes_per_s
        rows.append((max(t, t_mem), rec, hbm))
    rows.sort(key=lambda r: -r[0])
    total_t = sum(r[0] for r in rows) or 1.0
    out = [f"{'kernel':<34}{'cat':<12}{'x':>5}{'FLOPs':>10}{'HBM B':>10}"
           f"{'AI_hbm':>8}{'AI_' + machine.vmem.name:>8}{'t_bound':>10}{'%':>6}"]
    for t, rec, hbm in rows[:top_n]:
        ai_v = rec.ai("vmem")
        out.append(
            f"{rec.name[:33]:<34}{rec.category:<12}{rec.exec_count:>5}"
            f"{_fmt_si(rec.total_flops):>10}{_fmt_si(rec.total_hbm_bytes):>10}"
            f"{hbm.ai:>8.2f}{(0.0 if math.isinf(ai_v) else ai_v):>8.2f}"
            f"{t*1e6:>9.1f}u{100*t/total_t:>5.1f}")
    if len(rows) > top_n:
        rest = sum(r[0] for r in rows[top_n:])
        out.append(f"{'... ' + str(len(rows)-top_n) + ' more':<61}"
                   f"{'':>19}{rest*1e6:>9.1f}u{100*rest/total_t:>5.1f}")
    return "\n".join(out)


def zero_ai_table(census_by_phase: dict[str, dict[str, tuple[int, int]]]) -> str:
    """Paper Table III: zero-AI kernel invocations per phase."""
    phases = list(census_by_phase)
    out = [f"{'':<14}" + "".join(f"{p:>22}" for p in phases) + f"{'Total':>10}"]
    for kind in ("zero-AI", "non zero-AI"):
        cells, tot = [], 0
        for p in phases:
            inv, _ = census_by_phase[p][kind]
            both = sum(census_by_phase[p][k][0] for k in
                       ("zero-AI", "non zero-AI")) or 1
            cells.append(f"{inv} ({100*inv/both:.1f}%)")
            tot += inv
        out.append(f"{kind:<14}" + "".join(f"{c:>22}" for c in cells)
                   + f"{tot:>10}")
    totals = [sum(census_by_phase[p][k][0] for k in
                  ("zero-AI", "non zero-AI")) for p in phases]
    out.append(f"{'Total':<14}"
               + "".join(f"{str(t) + ' (100%)':>22}" for t in totals)
               + f"{sum(totals):>10}")
    return "\n".join(out)


def _phase_metric(m: object, key: str, default=0.0):
    """Metric from a PhaseMeasurement *or* a payload dict."""
    if isinstance(m, dict):
        return m.get(key, default)
    return getattr(m, key, default)


def achieved_table(results: "dict[str, dict[str, object]]") -> str:
    """Measured-vs-bound summary per (config × phase)."""
    out = [f"{'config/phase':<30}{'wall':>11}{'bound_ov':>11}{'bound_ser':>11}"
           f"{'achieved':>12}{'%roof':>8}{'dominant':>12}"]
    for config, phases in results.items():
        for phase, m in phases.items():
            wall = float(_phase_metric(m, "wall_s"))
            out.append(
                f"{(config + '/' + phase)[:29]:<30}"
                f"{wall*1e3:>9.3f}ms"
                f"{float(_phase_metric(m, 'bound_overlap_s'))*1e3:>9.3f}ms"
                f"{float(_phase_metric(m, 'bound_serial_s'))*1e3:>9.3f}ms"
                f"{_fmt_si(float(_phase_metric(m, 'achieved_flops_per_s')), 'F/s'):>12}"
                f"{100*float(_phase_metric(m, 'pct_of_roofline')):>7.1f}%"
                f"{str(_phase_metric(m, 'dominant', '')):>12}")
    return "\n".join(out)


def sweep_table(rows: Sequence[dict]) -> str:
    """Ranked cross-config campaign summary (``sweep report``).

    One row per sweep point, best %-of-roofline first; analytical
    (bound-only) points carry no achieved numbers and sort last.  A row
    (``repro_torch.sweep.aggregate.summary_rows``) carries ``label``,
    ``measured``, ``wall_s``, ``bound_overlap_s``,
    ``achieved_flops_per_s``, ``pct_of_roofline``, the per-level time
    fractions ``hbm_frac`` / ``vmem_frac`` (``vmem`` is the on-chip level:
    L2 on Hopper) and ``dominant``.
    """
    out = [f"{'#':>3} {'point':<38}{'wall':>11}{'bound':>11}{'achieved':>12}"
           f"{'%roof':>8}{'hbm%':>7}{'vmem%':>7}{'dominant':>12}"]
    ranked = sorted(
        rows, key=lambda r: (not r["measured"],
                             -float(r.get("pct_of_roofline", 0.0)),
                             -float(r.get("bound_overlap_s", 0.0))))
    for i, r in enumerate(ranked, 1):
        wall = float(r.get("wall_s", 0.0))
        meas = r["measured"] and wall > 0
        out.append(
            f"{i:>3} {r['label'][:37]:<38}"
            + (f"{wall*1e3:>9.3f}ms" if meas else f"{'--':>11}")
            + f"{float(r['bound_overlap_s'])*1e3:>9.3f}ms"
            + (f"{_fmt_si(float(r['achieved_flops_per_s']), 'F/s'):>12}"
               f"{100*float(r['pct_of_roofline']):>7.1f}%"
               f"{100*float(r['hbm_frac']):>6.1f}%"
               f"{100*float(r['vmem_frac']):>6.1f}%"
               if meas else f"{'--':>12}{'--':>8}{'--':>7}{'--':>7}")
            + f"{str(r.get('dominant', '')):>12}")
    n_meas = sum(1 for r in rows if r["measured"])
    out.append(f"{len(rows)} point(s) | {n_meas} measured, "
               f"{len(rows)-n_meas} analytical (bound-only) | "
               "ranked by %-of-roofline (achieved wall vs perfect-overlap "
               "bound); hbm%/vmem% = fraction of wall at that level's "
               "bandwidth bound")
    return "\n".join(out)


def terms_table(results: dict[str, object]) -> str:
    """Three-term roofline summary across experiments."""
    out = [f"{'experiment':<34}{'compute':>11}{'memory':>11}{'coll':>11}"
           f"{'dominant':>12}{'fraction':>10}"]
    for name, res in results.items():
        t = res.terms if hasattr(res, "terms") else res
        out.append(f"{name[:33]:<34}{t.compute_s*1e3:>9.3f}ms"
                   f"{t.memory_s*1e3:>9.3f}ms{t.collective_s*1e3:>9.3f}ms"
                   f"{t.dominant:>12}{t.roofline_fraction:>10.3f}")
    return "\n".join(out)


def machine_table(machine: MachineSpec) -> str:
    """Machine-characterization summary (paper §II-A as a table)."""
    src = "empirical (measured)" if machine.empirical else "datasheet"
    out = [f"machine {machine.name} [{src}]",
           f"{'ceiling':<22}{'peak':>14}{'ridge@hbm':>12}"]
    for cls in sorted(machine.peak_flops):
        peak = machine.peak_flops[cls]
        out.append(f"{'compute/' + cls:<22}{_fmt_si(peak, 'FLOP/s'):>14}"
                   f"{machine.ridge_point(cls):>10.1f} AI")
    for lv in machine.mem_levels:
        cap = (f"cap {_fmt_si(lv.capacity_bytes, 'B')}"
               if lv.capacity_bytes else "uncapped")
        out.append(f"{'memory/' + lv.name:<22}{_fmt_si(lv.bytes_per_s, 'B/s'):>14}"
                   f"  {cap}")
    for lv in machine.interconnect:
        if machine.net_levels:
            note = "measured collective ceiling"
        elif lv.name == "ici":
            note = f"{machine.ici_links} link(s), datasheet"
        else:
            note = "datasheet"
        if lv.latency_s:
            note += f", lat {lv.latency_s*1e6:.1f} us"
        out.append(f"{'network/' + lv.name:<22}"
                   f"{_fmt_si(lv.bytes_per_s, 'B/s'):>14}  {note}")
    return "\n".join(out)
