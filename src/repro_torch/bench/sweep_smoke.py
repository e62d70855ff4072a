"""sweep_smoke: the campaign engine end to end, in miniature (port of
``benchmarks/sweep_smoke.py``).

Runs a 2-config measured mini-sweep inline (no worker pool) on the
device into a throwaway store, checks one schema-versioned record per
point landed with the point's content hash in ``meta``, renders the
ranked cross-config summary, then runs a 1-config *analytical* sweep
(on meta tensors) twice to show that the per-point analysis cache
short-circuits the second pass.  The machine is the card's datasheet
(``cpu-host`` on the host).

Run: ``python -m repro_torch.bench --only sweep_smoke [--device cpu]``.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from repro_torch.bench.common import Row, datasheet
from repro_torch.core.machine import CPU_HOST

CONFIGS = ("minitron-4b", "mamba2-1.3b")


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.sweep.aggregate import (latest_per_point, render_summary,
                                             summary_rows, sweep_records)
    from repro_torch.sweep.engine import run_sweep
    from repro_torch.sweep.spec import SweepSpec
    from repro_torch.trace.store import TraceStore

    machine = datasheet(device, host=CPU_HOST).name
    rows: list[Row] = []
    with tempfile.TemporaryDirectory() as d:
        store_path = os.path.join(d, "sweep.jsonl")
        cache_dir = os.path.join(d, "cache")

        spec = SweepSpec(name="bench", configs=CONFIGS, seqs=(16,),
                         batches=(2,), amps=("O1",), meshes=((1, 1),),
                         machine=machine, measure=True, smoke=True,
                         iters=2, warmup=1)
        points, skipped = spec.expand()
        assert len(points) == len(CONFIGS) and not skipped
        result = run_sweep(spec, store_path=store_path, workers=0,
                           cache_dir=None, device=str(device))
        assert result.n_ok == len(points), [r.error for r in result.results]

        store = TraceStore(store_path)
        recs = latest_per_point(sweep_records(store, "bench"))
        assert len(recs) == len(points), "one store record per sweep point"
        for key, rec in recs.items():
            assert rec.meta["sweep_point"] == key
            assert rec.phases, "phases persisted"
        table = render_summary(recs)
        assert all(c in table for c in CONFIGS), table
        for row in summary_rows(recs):
            assert row["measured"] and row["wall_s"] > 0
            rows.append((f"sweep_smoke/{row['label']}", row["wall_s"] * 1e6,
                         f"roof={100*row['pct_of_roofline']:.1f}%;"
                         f"dominant={row['dominant']}"))

        # analytical pass: the second run must come from the point cache
        an = SweepSpec(name="bench-an", configs=CONFIGS[:1], seqs=(16,),
                       batches=(2,), amps=("O1",), meshes=((1, 1),),
                       measure=False)
        t0 = time.time()
        first = run_sweep(an, store_path=store_path, workers=0,
                          cache_dir=cache_dir)
        t_cold = time.time() - t0
        assert first.n_ok == 1 and first.n_cached == 0
        t0 = time.time()
        second = run_sweep(an, store_path=store_path, workers=0,
                           cache_dir=cache_dir)
        t_warm = time.time() - t0
        assert second.n_ok == 1 and second.n_cached == 1, \
            "second analytical pass should hit the cache"
        assert t_warm < t_cold, (t_warm, t_cold)
        rows.append(("sweep_smoke/cache_cold", t_cold * 1e6, "analytical"))
        rows.append(("sweep_smoke/cache_warm", t_warm * 1e6, "cache hit"))
    return rows
