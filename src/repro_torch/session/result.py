"""RooflineResult: the one return type of every Session method (port of
``repro.session.result``).  Phase payloads use the trace-store schema, so
the report helpers render them unchanged."""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.machine import MachineSpec

#: RooflineResult.kind values the port produces
KINDS = ("characterize", "profile", "record", "report", "compare", "tune",
         "sweep", "trend", "advise", "merge")


@dataclasses.dataclass(frozen=True)
class LevelStat:
    """Achieved vs bound at one memory level (the hierarchical view)."""

    level: str
    bytes: float
    bound_s: float
    achieved_bytes_per_s: float      # 0 = analytical only
    frac_of_peak: float


def phases_from_record(rec: Any) -> dict[str, dict[str, Any]]:
    """Phase payloads of a stored TraceRecord (defensive copy)."""
    return {name: dict(p) for name, p in rec.phases.items()}


def payload_from_profile(res: Any) -> dict[str, Any]:
    """Trace-schema phase payload from an *analytical* ProfileResult."""
    t = res.terms
    return {
        "wall_s": res.wall_s or 0.0,
        "iters": res.measure_iters,
        "achieved_flops_per_s": 0.0,
        "pct_of_roofline": 0.0,
        "bound_overlap_s": t.bound_overlap_s,
        "bound_serial_s": t.bound_serial_s,
        "compute_s": t.compute_s,
        "memory_s": t.memory_s,
        "collective_s": t.collective_s,
        "dominant": t.dominant,
        "flops": res.analysis.total_flops,
        "hbm_bytes": res.analysis.total_hbm_bytes,
        "vmem_bytes": res.analysis.total_vmem_bytes,
        "ici_bytes": t.ici_wire_bytes,
        "dcn_bytes": t.dcn_wire_bytes,
        "net_bytes": t.ici_wire_bytes + t.dcn_wire_bytes,
        "ici_bound_s": t.collective_ici_s,
        "dcn_bound_s": t.collective_dcn_s,
        "kernels": [],
    }


@dataclasses.dataclass
class RooflineResult:
    """Machine + per-phase payloads + provenance, for one step."""

    kind: str
    name: str
    machine: MachineSpec
    provenance: dict[str, Any] = dataclasses.field(default_factory=dict)
    phases: dict[str, dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    analyses: dict[str, Any] = dataclasses.field(default_factory=dict)
    text: str = ""
    data: Any = None
    #: CLI exit status this result implies (compare: 1 on regression)
    exit_code: int = 0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown RooflineResult kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    @property
    def measured(self) -> bool:
        return any(float(p.get("wall_s", 0.0)) > 0
                   for p in self.phases.values())

    def levels(self, phase: str) -> list[LevelStat]:
        """Per-memory-level achieved/bound for one phase.  The on-chip
        level's bytes are the payload's ``vmem_bytes``."""
        p = self.phases[phase]
        wall = float(p.get("wall_s", 0.0))
        out = []
        for lv in self.machine.mem_levels:
            key = "hbm_bytes" if lv is self.machine.hbm else "vmem_bytes"
            nbytes = float(p.get(key, 0.0))
            achieved = nbytes / wall if wall else 0.0
            out.append(LevelStat(
                level=lv.name, bytes=nbytes,
                bound_s=nbytes / lv.bytes_per_s if lv.bytes_per_s else 0.0,
                achieved_bytes_per_s=achieved,
                frac_of_peak=achieved / lv.bytes_per_s
                if lv.bytes_per_s else 0.0))
        return out

    def summary(self) -> str:
        bits = [f"[{self.kind}] {self.name}", f"machine={self.machine.name}"]
        if "device" in self.provenance:
            bits.append(f"device={self.provenance['device']}")
        if "run_id" in self.provenance:
            bits.append(f"run={self.provenance['run_id']}")
        if self.phases:
            bits.append(f"phases={','.join(self.phases)}")
            if self.measured:
                wall = sum(float(p.get("wall_s", 0.0))
                           for p in self.phases.values())
                bits.append(f"wall={wall*1e3:.3f}ms")
        return " ".join(bits)

    def render(self, charts: int = 0, top_kernels: int = 10) -> str:
        """Human-readable report; ``charts`` > 0 adds up to that many
        per-phase roofline charts."""
        from repro_torch.core.report import (achieved_table, ascii_roofline,
                                             kernel_table, machine_table,
                                             terms_table)

        parts = [self.summary()]
        if self.kind == "characterize":
            parts.append(self.text or machine_table(self.machine))
        elif self.kind == "compare":
            parts.append(self.text)
        else:
            if self.measured:
                parts.append(achieved_table({self.name: self.phases}))
            elif self.data is not None and self.kind == "profile":
                parts.append(terms_table(
                    {f"{self.name}/{ph}": res
                     for ph, res in self.data.items()}))
            for n, (ph, analysis) in enumerate(self.analyses.items()):
                parts.append(f"-- {ph} --\n" + kernel_table(
                    analysis, self.machine, top_n=top_kernels))
                if n < charts:
                    parts.append(ascii_roofline(
                        analysis.kernels, self.machine,
                        title=f"{self.name}/{ph}",
                        achieved=self._achieved_points(ph)))
            if self.text:
                parts.append(self.text)
        return "\n\n".join(p for p in parts if p)

    def _achieved_points(self, phase: str) -> list[tuple[float, float]]:
        pts = []
        for k in self.phases.get(phase, {}).get("kernels", ()):
            ai = float(k.get("ai_hbm", 0.0))
            fs = float(k.get("achieved_flops_per_s", 0.0))
            if ai > 0 and fs > 0:
                pts.append((ai, fs))
        return pts
