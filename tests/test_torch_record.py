"""The port's ``record`` / ``report`` / ``compare`` and its JSONL trace
store, read back through the reference's ``repro.trace`` modules.

Records are measured on the host (``Session(device="cpu")``) at the smoke
size.  Where a test needs two runs to compare equal, the profiler's timer
is replaced by a fixed per-call time, so host noise cannot flag (or hide)
a regression; the measured path and everything after it run as written.
"""

import json
import subprocess
import sys

import pytest

from repro.trace import compare as r_compare
from repro.trace import store as r_store
from repro_torch import cli
from repro_torch.core import profiler
from repro_torch.session.session import Session
from repro_torch.session.workspace import Workspace
from repro_torch.trace import compare as p_compare
from repro_torch.trace import store as p_store

SMOKE = dict(seq=16, batch=2, iters=1, warmup=1)


@pytest.fixture
def fixed_timer(monkeypatch):
    """Every timed call takes 5 ms; the phase still runs once."""
    def samples(fn, args, *, iters=10, warmup=3):
        return [0.005] * max(iters, 1), fn(*args)
    monkeypatch.setattr(profiler, "time_samples", samples)


def test_record_parses_through_the_reference_store(tmp_path):
    s = Session(device="cpu", workspace=str(tmp_path))
    res = s.record("glm4-9b", attn_impl="flash", **SMOKE)
    assert res.kind == "record" and "step:" in res.text
    recs = r_store.TraceStore(s.workspace.trace_path).records()
    assert [r.run_id for r in recs] == [res.data.run_id]
    rec = recs[0]
    assert rec.schema_version == r_store.SCHEMA_VERSION
    assert rec.config == "glm4-9b" and rec.machine == "cpu-host"
    assert list(rec.phases) == ["fwd", "bwd", "opt"]
    for payload in rec.phases.values():
        assert set(r_store.PHASE_METRICS) <= set(payload)
        assert payload["wall_s"] > 0 and payload["launches"] > 0
    assert rec.meta["attn_impl"] == "flash" and rec.meta["seq"] == 16
    assert rec.host["backend"] == "cpu" and "torch" in rec.host
    assert p_store.PHASE_METRICS == r_store.PHASE_METRICS
    header = json.loads(open(s.workspace.header_path).read())
    assert header["machine"] == "cpu-host"
    assert header["stores"]["trace"] == "trace.jsonl"


def test_reference_compare_flags_scaled_wall_only(tmp_path, fixed_timer):
    s = Session(device="cpu", workspace=str(tmp_path))
    base = s.record("glm4-9b", **SMOKE).data
    same = s.record("glm4-9b", scale_wall=1.0, **SMOKE).data
    slow = s.record("glm4-9b", scale_wall=2.0, **SMOKE).data
    recs = {r.run_id: r for r in
            r_store.TraceStore(s.workspace.trace_path).records()}
    b, n, w = recs[base.run_id], recs[same.run_id], recs[slow.run_id]
    assert not r_compare.has_regressions(r_compare.compare_records(b, n))
    flagged = r_compare.regressions(r_compare.compare_records(b, w))
    assert {(d.phase, d.metric) for d in flagged} >= {
        ("fwd", "wall_s"), ("bwd", "wall_s"), ("opt", "wall_s")}
    # the port's compare agrees with the reference's, cell for cell
    assert [(d.phase, d.metric, d.regression) for d in
            p_compare.compare_records(base, slow)] == \
        [(d.phase, d.metric, d.regression) for d in
         r_compare.compare_records(b, w)]
    res = s.compare()
    assert res.exit_code == 1 and "regression" in res.text


def test_torn_final_line_is_repaired_on_the_next_append(tmp_path):
    s = Session(device="cpu", workspace=str(tmp_path))
    first = s.record("glm4-9b", **SMOKE).data
    path = s.workspace.trace_path
    with open(path, "a") as f:
        f.write('{"schema_version": 1, "run_id": "torn", "pha')
    with pytest.warns(UserWarning, match="corrupt line skipped"):
        assert [r.run_id for r in p_store.TraceStore(path).last(n=5)] == \
            [first.run_id]
    second = s.record("glm4-9b", **SMOKE).data
    lines = open(path).read().splitlines()
    assert len(lines) == 2 and all(json.loads(line) for line in lines)
    assert [r.run_id for r in r_store.TraceStore(path).records()] == \
        [first.run_id, second.run_id]
    assert s.report().data.run_id == second.run_id
    assert p_store.TraceStore(path).run(second.run_id[:6]).run_id == \
        second.run_id
    assert p_store.TraceStore(path).configs() == ["glm4-9b"]


def test_workspace_resolution(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_WORKSPACE", str(tmp_path / "env"))
    assert Workspace().root == str(tmp_path / "env")
    assert Workspace(str(tmp_path / "x")).root == str(tmp_path / "x")
    ws = Workspace.for_store(str(tmp_path / "d" / "runs.jsonl"))
    assert ws.trace_path == str(tmp_path / "d" / "runs.jsonl")
    monkeypatch.delenv("REPRO_WORKSPACE")
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".git").mkdir()
    assert Workspace().root == str(tmp_path / ".repro-workspace")


def test_cli_exit_codes(tmp_path, fixed_timer, capsys):
    store = str(tmp_path / "t.jsonl")
    common = ["--device", "cpu", "--store", store]
    run = ["--config", "glm4-9b", "--seq", "16", "--batch", "2", "--iters",
           "1", "--warmup", "1", *common]
    assert cli.main(["report", *common]) == 2          # nothing stored yet
    assert cli.main(["record", "--attn-impl", "flash", *run]) == 0
    assert cli.main(["record", "--attn-impl", "flash", *run]) == 0
    assert cli.main(["compare", *common]) == 0
    assert cli.main(["record", "--attn-impl", "flash", "--scale-wall", "2",
                     *run]) == 0
    assert cli.main(["compare", *common]) == 1
    assert cli.main(["report", "--config", "glm4-9b", *common]) == 0
    assert "[report] glm4-9b" in capsys.readouterr().out
    assert len(r_store.TraceStore(store).records()) == 3


def test_module_entry_point_exit_codes(tmp_path):
    """``python -m repro_torch``: ``report`` reads back a record, and the
    default device (``cuda``) is refused on a host without a card."""
    store = str(tmp_path / "t.jsonl")
    s = Session(device="cpu", workspace=Workspace.for_store(store))
    rid = s.record("glm4-9b", **SMOKE).data.run_id

    def run(*argv):
        return subprocess.run([sys.executable, "-m", "repro_torch", *argv],
                              capture_output=True, text=True, timeout=300)

    out = run("report", "--device", "cpu", "--store", store)
    assert out.returncode == 0 and "[report] glm4-9b" in out.stdout
    assert rid in out.stdout
    import torch
    if not torch.cuda.is_available():
        assert run("compare", "--store", store).returncode == 2
