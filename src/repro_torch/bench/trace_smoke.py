"""trace_smoke: the measured-roofline loop end to end, in miniature (port
of ``benchmarks/trace_smoke.py``).

Records two runs of one smoke config into a throwaway store (the second
with an injected 1.5× slowdown, as ``--scale-wall`` injects one), then
checks that ``repro_torch.trace.compare`` flags the injected regression
and that every stored phase carries the acceptance metrics (wall time,
achieved FLOP/s, %-of-roofline).  The phases run on the device (CUDA
events on the card, the host clock on the host) against its datasheet
(``cpu-host`` on the host).

Run: ``python -m repro_torch.bench --only trace_smoke [--device cpu]``.
"""

from __future__ import annotations

import os
import tempfile

import torch

from repro_torch.bench.common import Row, datasheet
from repro_torch.core.machine import CPU_HOST

CONFIG = "minitron-4b"
SLOWDOWN = 1.5
THRESHOLD = 0.10


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.trace.cli import build_measured_phases
    from repro_torch.trace.collector import collect_phases, scale_measurement
    from repro_torch.trace.compare import (compare_last, has_regressions,
                                           regressions)
    from repro_torch.trace.store import (PHASE_METRICS, TraceStore,
                                         record_from_phases)

    machine = datasheet(device, host=CPU_HOST)
    rows: list[Row] = []
    phases, _run = build_measured_phases(CONFIG, smoke=True, device=device)
    ms = collect_phases(phases, machine=machine, iters=3, warmup=1)

    for name, m in ms.items():
        rows.append((f"trace_smoke/{CONFIG}/{name}", m.wall_s * 1e6,
                     f"achieved={m.achieved_flops_per_s/1e9:.2f}GF/s;"
                     f"roofline={100*m.pct_of_roofline:.1f}%;"
                     f"dominant={m.dominant}"))

    with tempfile.TemporaryDirectory() as d:
        store = TraceStore(os.path.join(d, "trace.jsonl"))
        store.append(record_from_phases(CONFIG, ms, machine=machine.name))
        slowed = {k: scale_measurement(m, SLOWDOWN) for k, m in ms.items()}
        store.append(record_from_phases(CONFIG, slowed,
                                        machine=machine.name))

        recs = store.records(CONFIG)
        assert len(recs) == 2, recs
        for p in recs[0].phases.values():
            missing = [k for k in PHASE_METRICS if k not in p]
            assert not missing, f"phase payload missing {missing}"

        deltas = compare_last(store, CONFIG, threshold=THRESHOLD)
        flagged = regressions(deltas)
        assert has_regressions(deltas), "injected slowdown not flagged"
        wall_cells = [x for x in flagged if x.metric == "wall_s"]
        assert len(wall_cells) == len(ms), (
            f"every phase should flag wall_s: {wall_cells}")
        rows.append(("trace_smoke/compare_cells", 0.0, str(len(deltas))))
        rows.append(("trace_smoke/injected_regression_flagged", 0.0,
                     f"{len(flagged)} cells past "
                     f"{100*THRESHOLD:.0f}% (x{SLOWDOWN} slowdown)"))
    return rows
