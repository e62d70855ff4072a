"""Roofline math (port of ``repro.core.roofline``): paper Eq. (1) per
kernel and level, and the whole-program three-term bound::

    T >= max(T_compute, T_memory, T_collective)        (perfect overlap)
    T <= T_compute + T_memory + T_collective           (no overlap)
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.machine import MachineSpec
from repro_torch.core.op_analysis import KernelRecord, ModuleAnalysis


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    """One circle on the paper's charts: (AI, attainable and bound FLOP/s)."""

    kernel: str
    level: str                 # the machine's level name ("l2" | "hbm" ...)
    ai: float                  # FLOPs / byte at this level
    flops: float               # FLOPs of one execution
    dtype_class: str           # dominant ceiling class
    bound_flops_per_s: float   # min(peak, bw * AI)
    time_bound_s: float        # flops / bound


def kernel_points(rec: KernelRecord, machine: MachineSpec) -> list[RooflinePoint]:
    """Hierarchical pair for one kernel: on-chip level, then device memory."""
    if not rec.flops_by_class:
        cls = "f32"
    else:
        cls = max(rec.flops_by_class, key=rec.flops_by_class.get)
    peak = machine.peak_for(cls)
    pts = []
    for lv, nbytes in ((machine.vmem, rec.vmem_bytes),
                       (machine.hbm, rec.hbm_bytes)):
        ai = rec.flops / nbytes if nbytes else math.inf
        bound = min(peak, lv.bytes_per_s * ai) if math.isfinite(ai) else peak
        pts.append(RooflinePoint(
            kernel=rec.name, level=lv.name, ai=ai, flops=rec.flops,
            dtype_class=cls, bound_flops_per_s=bound,
            time_bound_s=rec.flops / bound if bound else 0.0))
    return pts


def attainable(ai: float, machine: MachineSpec, dtype_class: str = "bf16",
               level: str = "hbm") -> float:
    """Paper Eq. (1)."""
    return min(machine.peak_for(dtype_class),
               machine.level(level).bytes_per_s * ai)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_ici_s: float
    collective_dcn_s: float
    flops_by_class: dict[str, float]
    hbm_bytes: float
    ici_wire_bytes: float
    dcn_wire_bytes: float

    @property
    def collective_s(self) -> float:
        return self.collective_ici_s + self.collective_dcn_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_overlap_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bound_serial_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def roofline_fraction(self) -> float:
        b = self.bound_overlap_s
        return self.compute_s / b if b else 0.0

    def describe(self) -> str:
        return (f"compute {self.compute_s*1e3:.3f} ms | "
                f"memory {self.memory_s*1e3:.3f} ms | "
                f"collective {self.collective_s*1e3:.3f} ms "
                f"(ici {self.collective_ici_s*1e3:.3f} / "
                f"dcn {self.collective_dcn_s*1e3:.3f}) | "
                f"dominant={self.dominant} "
                f"fraction={self.roofline_fraction:.3f}")


def roofline_terms(analysis: ModuleAnalysis, machine: MachineSpec) -> RooflineTerms:
    """Three roofline terms from one device's analysis."""
    flops_by_class = analysis.total_flops_by_class
    compute_s = sum(f / machine.peak_for(cls)
                    for cls, f in flops_by_class.items())
    hbm = analysis.total_hbm_bytes
    memory_s = hbm / machine.hbm.bytes_per_s
    ici_bytes = analysis.collective_wire_bytes(cross_pod=False)
    dcn_bytes = analysis.collective_wire_bytes(cross_pod=True)
    ici_lv = machine.net_level("ici")
    dcn_lv = machine.net_level("dcn")
    n_ici = sum(c.exec_count for c in analysis.collectives if not c.cross_pod)
    n_dcn = sum(c.exec_count for c in analysis.collectives if c.cross_pod)
    ici_s = ici_bytes / ici_lv.bytes_per_s + ici_lv.latency_s * n_ici
    dcn_s = dcn_bytes / dcn_lv.bytes_per_s + dcn_lv.latency_s * n_dcn
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s,
        collective_ici_s=ici_s, collective_dcn_s=dcn_s,
        flops_by_class=flops_by_class, hbm_bytes=hbm,
        ici_wire_bytes=ici_bytes, dcn_wire_bytes=dcn_bytes)


def model_flops_ratio(model_flops_global: float, analysis: ModuleAnalysis,
                      n_devices: int) -> float:
    """MODEL_FLOPS / walked FLOPs: the share of the executed compute that
    is 'useful' (the reference's, over the op walk in place of the HLO).
    ``remat`` lowers it by the recompute the backward adds."""
    walked = analysis.total_flops * n_devices
    return model_flops_global / walked if walked else 0.0
