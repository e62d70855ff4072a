"""serve_bench: continuous-batching serving under a seeded arrival trace
(port of ``benchmarks/serve_bench.py``).

The acceptance loop for ``repro_torch.serve``: drive the smoke config
through ``Session.serve`` (a 16-request Poisson trace, paged KV-cache,
chunked prefill interleaved with decode) on the device and gate on

* **latency** — the admitted-never-completed / p99 TTFT / p99 per-token
  gate must pass (a wedged scheduler fails the suite; the absolute
  bounds are generous);
* **phase attribution** — the stored record carries *distinct* prefill
  and decode phase payloads, and decode is more bandwidth-bound than
  chunked prefill at small batch (``memory_bound_fraction(decode) >
  memory_bound_fraction(prefill)``), checked on the analytical envelope
  so it is the same on every host;
* **round trip** — ``Session.report`` re-renders the run from the store.

Rows: tokens/s, p50/p99 TTFT and per-token latency, each phase's wall
and memory-bound fraction; each becomes a ``python -m repro_torch trend``
series.  The walls are the host clock around calls that end in a
synchronize; the bounds are against the session's machine (the card's
datasheet, ``cpu-host`` on the host).

Run: ``python -m repro_torch.bench --only serve_bench [--device cpu]``.
"""

from __future__ import annotations

import os
import tempfile

import torch

from repro_torch.bench.common import Row

CONFIG = "minitron-4b"
N_REQUESTS = 16
#: the reference's ``Session.serve`` arguments
SERVE_ARGS = dict(n_requests=N_REQUESTS, trace="poisson", rate=1.0, seed=0,
                  n_slots=2, max_len=32, prefill_chunk=8, page_size=8)


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.serve.trace import memory_bound_fraction
    from repro_torch.session.session import Session
    from repro_torch.session.workspace import Workspace

    rows: list[Row] = []
    with tempfile.TemporaryDirectory() as d:
        s = Session(device=device,
                    workspace=Workspace(os.path.join(d, "ws")))
        res = s.serve(CONFIG, **SERVE_ARGS)
        rec, stats = res.data[:2]
        summ = stats.summary()

        # latency gate: Session.serve folds it into the exit code
        assert res.exit_code == 0, f"latency gate failed:\n{res.text}"
        assert summ["completed"] == N_REQUESTS, summ
        assert summ["new_tokens"] > 0 and summ["tokens_per_s"] > 0, summ

        # distinct per-phase payloads, decode more bandwidth-bound
        assert set(rec.phases) == {"prefill", "decode"}, sorted(rec.phases)
        mf = {ph: memory_bound_fraction(p) for ph, p in rec.phases.items()}
        assert mf["decode"] > mf["prefill"], (
            f"decode must be more bandwidth-bound than chunked prefill "
            f"at small batch: {mf}")
        for ph, p in rec.phases.items():
            assert p["wall_s"] > 0 and p["launches"] > 0, (ph, p)
            assert p["kernels"], f"{ph}: no kernel attribution"
        assert rec.meta["kernel_configs"] is not None

        # round trip: the stored record re-renders without re-running
        rep = s.report(f"serve/{CONFIG}")
        assert rep.data.run_id == rec.run_id
        assert rep.measured and set(rep.phases) == {"prefill", "decode"}

        rows.append((f"serve_bench/{CONFIG}_tok_s",
                     1e6 / summ["tokens_per_s"],
                     f"tok_s={summ['tokens_per_s']:.1f};"
                     f"completed={summ['completed']}/{summ['requests']};"
                     f"ticks={summ['ticks']}"))
        rows.append((f"serve_bench/{CONFIG}_ttft",
                     summ["ttft_p50_s"] * 1e6,
                     f"p50_ms={summ['ttft_p50_s'] * 1e3:.1f};"
                     f"p99_ms={summ['ttft_p99_s'] * 1e3:.1f}"))
        rows.append((f"serve_bench/{CONFIG}_tpot",
                     summ["tpot_p50_s"] * 1e6,
                     f"p50_ms={summ['tpot_p50_s'] * 1e3:.1f};"
                     f"p99_ms={summ['tpot_p99_s'] * 1e3:.1f}"))
        for ph in ("prefill", "decode"):
            p = rec.phases[ph]
            rows.append((f"serve_bench/{CONFIG}_{ph}",
                         p["wall_s"] * 1e6,
                         f"mem_frac={mf[ph]:.3f};"
                         f"launches={p['launches']};"
                         f"calls={p['iters']};"
                         f"dominant={p['dominant']}"))
    return rows
