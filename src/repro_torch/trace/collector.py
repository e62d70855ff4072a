"""Measured-time collection (port of ``repro.trace.collector``): spread a
measured wall time across kernels by their analytical bound time, giving
per-kernel achieved FLOP/s and %-of-roofline (the time-based roofline).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.machine import MachineSpec, get_machine
from repro_torch.core.op_analysis import KernelRecord, ModuleAnalysis
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.roofline import RooflineTerms, kernel_points


@dataclasses.dataclass(frozen=True)
class KernelMeasurement:
    """One kernel with measured time attributed onto its analytical bound."""

    name: str
    category: str
    exec_count: int
    flops: float                    # total FLOPs (x exec_count)
    hbm_bytes: float                # total operand + result traffic
    ai_hbm: float
    bound_s: float                  # analytical lower bound on time
    attributed_s: float             # share of the measured wall time
    achieved_flops_per_s: float
    pct_of_roofline: float          # bound_s / attributed_s
    vmem_bytes: float = 0.0         # total on-chip-level traffic


@dataclasses.dataclass
class PhaseMeasurement:
    """One profiled-and-measured phase."""

    name: str
    wall_s: float
    iters: int
    machine: str
    terms: RooflineTerms
    kernels: list[KernelMeasurement]
    flops: float
    hbm_bytes: float
    vmem_bytes: float = 0.0

    @property
    def achieved_flops_per_s(self) -> float:
        return self.flops / self.wall_s if self.wall_s else 0.0

    @property
    def pct_of_roofline(self) -> float:
        return self.terms.bound_overlap_s / self.wall_s if self.wall_s else 0.0

    @property
    def bound_overlap_s(self) -> float:
        return self.terms.bound_overlap_s

    @property
    def bound_serial_s(self) -> float:
        return self.terms.bound_serial_s

    @property
    def dominant(self) -> str:
        return self.terms.dominant


def kernel_bound_s(rec: KernelRecord, machine: MachineSpec) -> float:
    """The larger of a kernel's HBM-roofline bound and its pure
    memory-streaming time."""
    pts = kernel_points(rec, machine)
    hbm = next(p for p in pts if p.level == machine.hbm.name)
    t = hbm.time_bound_s * rec.exec_count
    t_mem = rec.total_hbm_bytes / machine.hbm.bytes_per_s
    return max(t, t_mem)


def attribute_time(analysis: ModuleAnalysis, machine: MachineSpec,
                   wall_s: float) -> list[KernelMeasurement]:
    """Spread measured wall time over kernels by bound-time weight
    (evenly if every bound is zero); sorted by attributed time."""
    recs = list(analysis.kernels)
    if not recs:
        return []
    bounds = [kernel_bound_s(r, machine) for r in recs]
    total = sum(bounds)
    out = []
    for rec, bound in zip(recs, bounds):
        weight = bound / total if total else 1.0 / len(recs)
        t_attr = wall_s * weight
        out.append(KernelMeasurement(
            name=rec.name, category=rec.category,
            exec_count=rec.exec_count,
            flops=rec.total_flops, hbm_bytes=rec.total_hbm_bytes,
            ai_hbm=rec.total_flops / rec.total_hbm_bytes
            if rec.total_hbm_bytes else 0.0,
            bound_s=bound, attributed_s=t_attr,
            achieved_flops_per_s=rec.total_flops / t_attr if t_attr else 0.0,
            pct_of_roofline=bound / t_attr if t_attr else 0.0,
            vmem_bytes=rec.total_vmem_bytes))
    out.sort(key=lambda k: -k.attributed_s)
    return out


def measurement_from_profile(res: ProfileResult,
                             machine: MachineSpec | str) -> PhaseMeasurement:
    """PhaseMeasurement from a ProfileResult profiled with measure=True."""
    if isinstance(machine, str):
        machine = get_machine(machine)
    if res.wall_s is None:
        raise ValueError(f"{res.name}: ProfileResult has no wall_s — "
                         "profile with measure=True first")
    return PhaseMeasurement(
        name=res.name, wall_s=res.wall_s, iters=res.measure_iters,
        machine=machine.name, terms=res.terms,
        kernels=attribute_time(res.analysis, machine, res.wall_s),
        flops=res.analysis.total_flops,
        hbm_bytes=res.analysis.total_hbm_bytes,
        vmem_bytes=res.analysis.total_vmem_bytes)


def scale_measurement(m: PhaseMeasurement, factor: float) -> PhaseMeasurement:
    """Scale a measurement's wall time (regression drills / tests)."""
    if factor == 1.0:
        return m
    kernels = [dataclasses.replace(
        k, attributed_s=k.attributed_s * factor,
        achieved_flops_per_s=k.achieved_flops_per_s / factor,
        pct_of_roofline=k.pct_of_roofline / factor)
        for k in m.kernels]
    return dataclasses.replace(m, wall_s=m.wall_s * factor, kernels=kernels)
