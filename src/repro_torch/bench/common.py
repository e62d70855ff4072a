"""Shared benchmark plumbing (port of ``benchmarks/common.py``): CSV rows
of ``(name, us_per_call, derived)``."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.machine import H100_SXM, MachineSpec, datasheet_for
from repro_torch.kernels.ert.ops import time_launches

Row = tuple[str, float, str]


def timed(fn: Callable, *args, iters: int = 3, warmup: int = 1,
          device: str | torch.device = "cuda") -> float:
    """Mean wall per call of ``fn(*args)`` in microseconds, after
    ``warmup`` calls: between two CUDA events on the card, on the host
    clock on the host (``kernels.ert.ops.time_launches``)."""
    return 1e6 * time_launches(lambda: fn(*args), torch.device(device),
                               iters=iters, warmup=warmup, min_total_s=0.0)


def datasheet(device: str | torch.device) -> MachineSpec:
    """The card's datasheet spec; on the host the H100 SXM's, the card
    the port is written for."""
    device = torch.device(device)
    if device.type == "cuda":
        return datasheet_for(torch.cuda.get_device_name(device))
    return H100_SXM


def emit(rows: Sequence[Row]) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
