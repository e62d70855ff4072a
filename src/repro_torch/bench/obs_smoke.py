"""obs_smoke: the fleet-observability loop against two small workspaces
(port of ``benchmarks/obs_smoke.py``).

The acceptance loop for ``repro_torch.obs``: record the smoke config on
the device into two throwaway workspaces ("machine A" and "machine B"),
then run the three observability verbs end to end —

* ``merge``  — B's stores fold into A (trace rows added, a provenance
  entry in ``workspace.json``); a second merge adds nothing (idempotency
  is the acceptance criterion),
* ``trend``  — A's gate passes on the honest runs, then flags a 2×
  slowdown (``scale_wall``) with a non-zero exit,
* ``advise`` — the rule engine fires on the smoke trace (an untuned
  ``fusion="off"`` run at smoke size is launch-overhead-dominated, so at
  least one finding cites evidence).

The machine is the session's default: the card's datasheet, ``cpu-host``
on the host.

Run: ``python -m repro_torch.bench --only obs_smoke [--device cpu]``.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from repro_torch.bench.common import Row

CONFIG = "minitron-4b"


def _timed(rows: list[Row], name: str, fn, derived=None):
    t0 = time.perf_counter()
    out = fn()
    rows.append((f"obs_smoke/{name}", (time.perf_counter() - t0) * 1e6,
                 derived(out) if derived else f"kind={out.kind}"))
    return out


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.session.session import Session
    from repro_torch.session.workspace import Workspace

    rows: list[Row] = []
    with tempfile.TemporaryDirectory() as d:
        wsA = Workspace(os.path.join(d, "wsA"))
        wsB = Workspace(os.path.join(d, "wsB"))
        a = Session(device=device, workspace=wsA)
        b = Session(device=device, workspace=wsB)

        # two honest runs on A (trend needs >= 2 points), one on B
        a.record(CONFIG, seq=16, batch=2, iters=2, warmup=1)
        a.record(CONFIG, seq=16, batch=2, iters=2, warmup=1)
        b.record(CONFIG, seq=16, batch=2, iters=2, warmup=1)

        # merge B into A: adds B's run, stamps provenance, idempotent
        m1 = _timed(rows, "merge", lambda: a.merge(wsB.root),
                    lambda r: f"added={sum(x.n_added for x in r.data)}")
        assert sum(r.n_added for r in m1.data) >= 1, "B's run must fold in"
        assert wsA.read_header().get("merges"), "provenance entry missing"
        m2 = a.merge(wsB.root)
        assert sum(r.n_added for r in m2.data) == 0, "re-merge must no-op"
        n_merges = len(wsA.read_header()["merges"])
        assert n_merges == 1, f"no-op merge must not add provenance " \
                              f"({n_merges} entries)"

        # trend gate: OK on honest runs ...
        ok = _timed(rows, "trend_gate_ok",
                    lambda: a.trend(CONFIG, gate=True),
                    lambda r: f"exit={r.exit_code}")
        assert ok.exit_code == 0, ok.text
        # ... non-zero after a synthetic 2x slowdown
        a.record(CONFIG, seq=16, batch=2, iters=2, warmup=1, scale_wall=2.0)
        bad = _timed(rows, "trend_gate_regress",
                     lambda: a.trend(CONFIG, gate=True),
                     lambda r: f"exit={r.exit_code};n={len(r.data[1])}")
        assert bad.exit_code != 0, "2x slowdown must trip the gate"
        assert any("wall_s" in reg.series.key + reg.series.metric
                   for reg in bad.data[1])

        # advisor: the smoke trace is launch-overhead bait by construction
        adv = _timed(rows, "advise", lambda: a.advise(CONFIG),
                     lambda r: f"findings={len(r.data)}")
        assert adv.data, "advisor must fire on the smoke trace"
        assert all(f.evidence for f in adv.data), "evidence-free finding"
        rows.append(("obs_smoke/rules_fired", 0.0,
                     ";".join(sorted({f.rule for f in adv.data}))))

        for res in (m1, ok, bad, adv):
            text = res.render()
            assert res.summary() in text
    return rows
