"""session_smoke: every Session method against one workspace root (port
of ``benchmarks/session_smoke.py``).

The acceptance loop for ``repro_torch.session``: a throwaway workspace,
one :class:`~repro_torch.session.session.Session` on the device, and the
paper's whole workflow — characterize → profile → record → report →
sweep → tune → compare — each method once on the smoke config.  It
asserts that

* every method returns a well-formed result that renders,
* the one workspace root ends up holding the three stores (trace, sweep,
  tune) and the shared machine-provenance header,
* ``compare`` reads back what ``record`` wrote (the same workspace, no
  paths exchanged).

The machine is the session's default: the card's datasheet, ``cpu-host``
on the host.

Run: ``python -m repro_torch.bench --only session_smoke [--device cpu]``.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from repro_torch.bench.common import Row

CONFIG = "minitron-4b"


def _timed(rows: list[Row], name: str, fn, derived: str = ""):
    t0 = time.perf_counter()
    out = fn()
    rows.append((f"session_smoke/{name}", (time.perf_counter() - t0) * 1e6,
                 derived or f"kind={out.kind}"))
    return out


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.session.session import Session
    from repro_torch.session.workspace import Workspace

    rows: list[Row] = []
    with tempfile.TemporaryDirectory() as d:
        ws = Workspace(os.path.join(d, "ws"))
        s = Session(device=device, workspace=ws)
        machine = s.machine.name

        char = _timed(rows, "characterize", lambda: s.characterize())
        assert char.machine.name == machine and char.text

        prof = _timed(rows, "profile", lambda: s.profile(
            CONFIG, seq=16, batch=2))
        assert set(prof.phases) == {"fwd", "bwd", "opt"}
        assert not prof.measured, "analytical profile must carry no wall"
        assert all(p["bound_overlap_s"] > 0 for p in prof.phases.values())

        rec1 = _timed(rows, "record", lambda: s.record(
            CONFIG, seq=16, batch=2, iters=2, warmup=1))
        assert rec1.measured and rec1.data.run_id
        rec2 = s.record(CONFIG, seq=16, batch=2, iters=2, warmup=1)

        rep = _timed(rows, "report", lambda: s.report(CONFIG))
        assert rep.data.run_id == rec2.data.run_id, \
            "report must read back the newest record from the workspace"

        sw = _timed(rows, "sweep", lambda: s.sweep(
            configs=(CONFIG,), seqs=(16,), batches=(2,), iters=2,
            warmup=1, workers=0))
        assert sw.data.n_ok == 1 and sw.exit_code == 0

        tu = _timed(rows, "tune", lambda: s.tune(["triad"], smoke=True))
        # the port tunes the triad through its ceiling searches (the HBM-
        # and L2-resident sizes ``characterize(tuned=True)`` reads); its
        # plain version on the host has no launch parameters
        triad = [o for o in tu.data.values() if o.record.kernel == "triad"]
        assert triad and all(o.record.wall_s > 0 for o in triad), tu.data

        cmp_ = _timed(rows, "compare", lambda: s.compare(CONFIG))
        assert cmp_.data, "compare must see the two recorded runs"

        # one root, all three stores and the shared provenance header
        present = sorted(os.listdir(ws.root))
        for required in ("trace.jsonl", "sweep.jsonl", "tune.json",
                         "workspace.json"):
            assert required in present, (required, present)
        header = ws.read_header()
        assert header["machine"] == machine
        rows.append(("session_smoke/workspace_files", 0.0,
                     ";".join(p for p in present if p != "sweep_cache")))

        # every result renders through the shared report helpers
        for res in (char, prof, rec1, rep, sw, tu, cmp_):
            text = res.render()
            assert res.summary() in text and len(text) > len(res.summary())
    return rows
