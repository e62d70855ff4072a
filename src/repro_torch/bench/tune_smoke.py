"""repro_torch.tune smoke: search → store → hit loop on a small space
(port of ``benchmarks/tune_smoke.py``).

The autotuner's round trip, as CI needs it proven:

1. a smoke-space search over the triad and the ERT GEMM persists the
   winners into a fresh store,
2. a second search over the same space is a 100% store hit (no timing),
3. the winners' before/after (default against tuned wall) is reported.

On the card it searches the hand-written kernels' launch configs
(backend ``cuda``, under the card's machine key); on the host their
plain versions (backend ``torch``, ``cpu-host``).

Run: ``python -m repro_torch.bench --only tune_smoke [--device cpu]``.
"""

from __future__ import annotations

import os
import tempfile

import torch

from repro_torch.bench.common import Row, datasheet
from repro_torch.core.machine import CPU_HOST


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.device import resolve_device
    from repro_torch.tune.search import search
    from repro_torch.tune.store import TuneStore

    dev = resolve_device(device)
    where = dict(machine=datasheet(dev, host=CPU_HOST).name,
                 backend="cuda" if dev.type == "cuda" else "torch")
    rows: list[Row] = []
    with tempfile.TemporaryDirectory() as td:
        store = TuneStore(os.path.join(td, "tune.json"))
        for kernel in ("triad", "ert_gemm"):
            first = search(kernel, store=store, smoke=True, **where)
            assert not first.cached
            params = ";".join(f"{k}={v}" for k, v in
                              sorted(first.record.params.items()))
            rows.append((f"tune_smoke/{kernel}_best",
                         first.record.wall_s * 1e6, params))
            rows.append((f"tune_smoke/{kernel}_default",
                         first.record.default_wall_s * 1e6,
                         f"speedup={first.speedup:.2f}x"))
            second = search(kernel, store=store, smoke=True, **where)
            assert second.cached and not second.candidates
            rows.append((f"tune_smoke/{kernel}_second_search", 0.0,
                         "store_hit"))
    return rows
