"""Application characterization: analysis plus timing (port of
``repro.core.profiler``).

:func:`profile_fn` analyzes a callable op by op on meta tensors
(:func:`repro_torch.core.op_analysis.analyze_fn`) and, with
``measure=True``, times **the same callable** on the tensors it was given:
on a CUDA device with CUDA events after warmup (median of the per-call
times, as the reference's ``time_compiled`` takes the median), on the
host with ``time.perf_counter``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Sequence

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.core.machine import MachineSpec, get_machine
from repro_torch.core.op_analysis import ModuleAnalysis, analyze_fn
from repro_torch.core.roofline import RooflineTerms, roofline_terms


@dataclasses.dataclass
class ProfileResult:
    name: str
    analysis: ModuleAnalysis
    terms: RooflineTerms
    wall_s: float | None = None      # measured median call time, if executed
    measure_iters: int = 0           # timed iterations behind wall_s
    peak_device_bytes: int = 0       # max_memory_allocated while timing (CUDA)
    output: Any = None               # what the last timed call returned


def args_device(args: Sequence[Any]) -> torch.device:
    """The device of the first tensor in ``args`` (CPU if there is none)."""
    for leaf in tree_flatten(tuple(args))[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def time_samples(fn: Callable, args: Sequence[Any], *, iters: int = 10,
                 warmup: int = 3) -> tuple[list[float], Any]:
    """Per-call seconds of ``fn(*args)`` and the last call's output.

    On CUDA each call sits between two CUDA events; the host waits for the
    device before reading them, so a sample is device time, not enqueue
    time.  The previous call's output is dropped before the next call, so
    a phase that returns a full set of gradients holds one set, not two.
    """
    dev = args_device(args)
    out = None
    with torch.no_grad():
        for _ in range(max(warmup, 1)):
            out = None
            out = fn(*args)
        times = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            for _ in range(max(iters, 1)):
                out = None
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
        else:
            for _ in range(max(iters, 1)):
                out = None
                t0 = time.perf_counter()
                out = fn(*args)
                times.append(time.perf_counter() - t0)
    return times, out


def profile_fn(fn: Callable, *, args: Sequence[Any], name: str | None = None,
               machine: MachineSpec | str = "h100-sxm",
               measure: bool = False, measure_iters: int = 10,
               measure_warmup: int = 3,
               matmul_class: str | None = None,
               devices_per_pod: int | None = None) -> ProfileResult:
    """Analyze ``fn(*args)`` op by op; with ``measure=True`` also time it.

    The analysis runs on meta stand-ins of ``args`` and allocates nothing;
    the timing runs ``fn`` itself on ``args`` (so ``args`` must be real
    tensors when ``measure=True``).  DTensor ``args`` make the analysis
    per device (``op_analysis.analyze_fn``), its collectives split at
    ``devices_per_pod``.
    """
    if isinstance(machine, str):
        machine = get_machine(machine)
    analysis = analyze_fn(fn, args, matmul_class=matmul_class,
                          devices_per_pod=devices_per_pod)
    res = ProfileResult(name=name or getattr(fn, "__name__", "fn"),
                        analysis=analysis,
                        terms=roofline_terms(analysis, machine))
    if measure:
        dev = args_device(args)
        if dev.type == "meta":
            raise ValueError(f"{res.name}: measure=True needs real tensors, "
                             "got meta tensors")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times, res.output = time_samples(fn, args, iters=measure_iters,
                                         warmup=measure_warmup)
        res.wall_s = statistics.median(times)
        res.measure_iters = measure_iters
        if dev.type == "cuda":
            res.peak_device_bytes = torch.cuda.max_memory_allocated(dev)
    return res
