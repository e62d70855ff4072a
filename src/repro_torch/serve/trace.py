"""Per-phase roofline attribution of a serve run, prefill against decode
(port of ``repro.serve.trace``).

The engine keeps each executable's per-call walls, hence its wall time
and call count (``prefill_first`` / ``prefill_ext`` / ``decode``).  This
module walks *those same callables* (:func:`repro_torch.core.profiler.profile_fn` on
meta stand-ins of one call's arguments, ``Engine.example_args``), scales
the one-call envelope by the number of calls, and folds the two prefill
variants into one ``prefill`` :class:`PhaseMeasurement` — so a serve run
lands in the trace store as an ordinary record (``serve/<config>``) with
two phases, in the schema ``repro.trace.store`` parses.

The question it answers is the paper's: at which level is each *phase*
bound?  Decode streams the whole parameter set and the KV cache per
generated token (low arithmetic intensity at a small batch); chunked
prefill amortizes the same weights over a chunk of tokens.
``memory_bound_fraction`` makes the comparison one number per phase.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core.machine import MachineSpec, get_machine
from repro_torch.core.profiler import ProfileResult, profile_fn
from repro_torch.core.roofline import RooflineTerms
from repro_torch.serve.engine import PHASE_OF
from repro_torch.trace.collector import (KernelMeasurement, PhaseMeasurement,
                                         attribute_time)


def scale_terms(t: RooflineTerms, n: float) -> RooflineTerms:
    """The three-term envelope of ``n`` identical calls."""
    return RooflineTerms(
        compute_s=t.compute_s * n,
        memory_s=t.memory_s * n,
        collective_ici_s=t.collective_ici_s * n,
        collective_dcn_s=t.collective_dcn_s * n,
        flops_by_class={k: v * n for k, v in t.flops_by_class.items()},
        hbm_bytes=t.hbm_bytes * n,
        ici_wire_bytes=t.ici_wire_bytes * n,
        dcn_wire_bytes=t.dcn_wire_bytes * n)


def sum_terms(a: RooflineTerms, b: RooflineTerms) -> RooflineTerms:
    classes = dict(a.flops_by_class)
    for k, v in b.flops_by_class.items():
        classes[k] = classes.get(k, 0.0) + v
    return RooflineTerms(
        compute_s=a.compute_s + b.compute_s,
        memory_s=a.memory_s + b.memory_s,
        collective_ici_s=a.collective_ici_s + b.collective_ici_s,
        collective_dcn_s=a.collective_dcn_s + b.collective_dcn_s,
        flops_by_class=classes,
        hbm_bytes=a.hbm_bytes + b.hbm_bytes,
        ici_wire_bytes=a.ici_wire_bytes + b.ici_wire_bytes,
        dcn_wire_bytes=a.dcn_wire_bytes + b.dcn_wire_bytes)


def memory_bound_fraction(payload: Mapping[str, Any]) -> float:
    """Share of the serial bound spent at the memory ceiling — the
    per-phase "how bandwidth-bound" number."""
    total = (payload.get("compute_s", 0.0) + payload.get("memory_s", 0.0)
             + payload.get("collective_s", 0.0))
    return payload.get("memory_s", 0.0) / total if total else 0.0


def _scale_kernel(k: KernelMeasurement, n: int) -> KernelMeasurement:
    """One kernel's totals across ``n`` executable calls.  ``attributed_s``
    already covers the accumulated wall (it was spread from the total),
    so only the per-call analytical quantities scale."""
    return dataclasses.replace(
        k, exec_count=k.exec_count * n, flops=k.flops * n,
        hbm_bytes=k.hbm_bytes * n, vmem_bytes=k.vmem_bytes * n,
        bound_s=k.bound_s * n,
        achieved_flops_per_s=(k.flops * n / k.attributed_s
                              if k.attributed_s else 0.0),
        pct_of_roofline=(k.bound_s * n / k.attributed_s
                         if k.attributed_s else 0.0))


def executable_measurement(name: str, res: ProfileResult,
                           machine: MachineSpec, wall_s: float,
                           n_calls: int) -> PhaseMeasurement:
    """One executable's accumulated serve time as a PhaseMeasurement.

    ``res`` is the walk of the *same* callable the engine drove; its
    one-call envelope scales by ``n_calls`` while ``wall_s`` is the
    engine's accumulated wall — so ``pct_of_roofline`` stays the
    whole-run efficiency.
    """
    kernels = [_scale_kernel(k, n_calls)
               for k in attribute_time(res.analysis, machine, wall_s)]
    return PhaseMeasurement(
        name=name, wall_s=wall_s, iters=n_calls, machine=machine.name,
        terms=scale_terms(res.terms, n_calls), kernels=kernels,
        flops=res.analysis.total_flops * n_calls,
        hbm_bytes=res.analysis.total_hbm_bytes * n_calls,
        vmem_bytes=res.analysis.total_vmem_bytes * n_calls)


def merge_measurements(name: str, parts: list[PhaseMeasurement]
                       ) -> PhaseMeasurement:
    """Fold several executables' measurements into one phase (the two
    prefill variants → ``prefill``)."""
    if len(parts) == 1:
        return dataclasses.replace(parts[0], name=name)
    terms = parts[0].terms
    for p in parts[1:]:
        terms = sum_terms(terms, p.terms)
    kernels = sorted((k for p in parts for k in p.kernels),
                     key=lambda k: -k.attributed_s)
    return PhaseMeasurement(
        name=name,
        wall_s=sum(p.wall_s for p in parts),
        iters=sum(p.iters for p in parts),
        machine=parts[0].machine,
        terms=terms, kernels=kernels,
        flops=sum(p.flops for p in parts),
        hbm_bytes=sum(p.hbm_bytes for p in parts),
        vmem_bytes=sum(p.vmem_bytes for p in parts))


def executable_profiles(engine: Any, machine: MachineSpec | str,
                        matmul_class: str | None = None
                        ) -> dict[str, ProfileResult]:
    """The op walk of each executable the engine ran (one call each, on
    meta tensors: nothing is allocated or launched)."""
    if isinstance(machine, str):
        machine = get_machine(machine)
    return {name: profile_fn(engine.executable(name),
                             args=engine.example_args(name), name=name,
                             machine=machine, matmul_class=matmul_class)
            for name in PHASE_OF if engine.calls.get(name, 0)}


def engine_phase_measurements(engine: Any, machine: MachineSpec | str,
                              matmul_class: str | None = None,
                              profiles: Mapping[str, ProfileResult]
                              | None = None
                              ) -> dict[str, PhaseMeasurement]:
    """``{"prefill": ..., "decode": ...}`` for every phase the engine
    actually ran (an executable never called contributes nothing);
    ``profiles`` reuses walks already taken (:func:`executable_profiles`)."""
    if isinstance(machine, str):
        machine = get_machine(machine)
    if profiles is None:
        profiles = executable_profiles(engine, machine, matmul_class)
    parts: dict[str, list[PhaseMeasurement]] = {}
    for exe_name, phase in PHASE_OF.items():
        n = engine.calls.get(exe_name, 0)
        if not n:
            continue
        parts.setdefault(phase, []).append(executable_measurement(
            exe_name, profiles[exe_name], machine, engine.wall[exe_name],
            n))
    return {phase: merge_measurements(phase, ps)
            for phase, ps in parts.items()}


def serve_record(config: str, engine: Any, stats: Any,
                 machine: MachineSpec | str,
                 matmul_class: str | None = None,
                 meta: Mapping[str, Any] | None = None,
                 profiles: Mapping[str, ProfileResult] | None = None):
    """TraceRecord of one serve run: ``serve/<config>`` with separate
    prefill/decode phase payloads plus the latency summary in ``meta``."""
    from repro_torch.trace.store import record_from_phases

    if isinstance(machine, str):
        machine = get_machine(machine)
    ms = engine_phase_measurements(engine, machine, matmul_class, profiles)
    return record_from_phases(
        f"serve/{config}", ms, machine=machine.name,
        meta={"serve": stats.summary(), **dict(meta or {})})
