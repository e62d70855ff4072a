"""The port's campaign resilience against the reference's: torn-tail repair
of the JSONL stores, the ``torn_tail`` fault of the trace store's append,
the campaign journal (byte for byte, each package replaying the other's),
and the supervised worker pool (ok and error outcomes, a crash with its
exit code and its worker replaced, a hung task killed at its deadline).

The pool's jobs are module functions (spawned workers import them by
reference); the reference is imported inside the tests, so a worker that
imports this module pulls in no jax.
"""

import json
import os

import pytest

from repro_torch.resilience import faults
from repro_torch.resilience import jsonl as p_jsonl
from repro_torch.resilience.journal import (CampaignJournal,
                                            journal_path_for)
from repro_torch.resilience.watchdog import SupervisedPool
from repro_torch.trace import store as p_store

GOOD = json.dumps({"run_id": "a", "x": 1})

#: (name, file content before the repair); None: no file
TAILS = [
    ("missing", None),
    ("empty", ""),
    ("clean", GOOD + "\n" + GOOD + "\n"),
    ("torn_fragment", GOOD + "\n" + '{"run_id": "b", "x'),
    ("whole_json_unsealed", GOOD + "\n" + GOOD),
    ("whole_file_torn", '{"run_id": "b", "x'),
    ("torn_after_blank", GOOD + "\n\n" + "garbage"),
    ("non_utf8_tail", GOOD + "\n" + "\udcff"),
]


@pytest.fixture
def fault_env(monkeypatch):
    """Set ``REPRO_FAULTS`` for one test (the plan is re-parsed when the
    variable changes)."""
    def set_plan(text):
        monkeypatch.setenv(faults.FAULT_ENV, text)
    yield set_plan
    monkeypatch.delenv(faults.FAULT_ENV, raising=False)


def _write(path, content):
    with open(path, "w", encoding="utf-8", errors="surrogateescape") as f:
        f.write(content)


@pytest.mark.parametrize("name,content", TAILS, ids=[t[0] for t in TAILS])
def test_repair_jsonl_tail_equals_reference(tmp_path, name, content):
    from repro.resilience import jsonl as r_jsonl
    out = []
    for pkg, fn in (("port", p_jsonl.repair_jsonl_tail),
                    ("ref", r_jsonl.repair_jsonl_tail)):
        path = tmp_path / f"{pkg}.jsonl"
        if content is not None:
            _write(path, content)
        n = fn(str(path))
        out.append((n, path.read_bytes() if path.exists() else None))
    assert out[0] == out[1]


def test_fsync_append_bytes_equal_reference(tmp_path):
    from repro.resilience import jsonl as r_jsonl
    for pkg, fn in (("port", p_jsonl.fsync_append),
                    ("ref", r_jsonl.fsync_append)):
        path = tmp_path / pkg / "s.jsonl"
        os.makedirs(path.parent)
        _write(path, GOOD + "\n" + '{"torn')
        fn(str(path), GOOD)
        fn(str(path), GOOD + "\n")
    assert (tmp_path / "port" / "s.jsonl").read_bytes() == \
        (tmp_path / "ref" / "s.jsonl").read_bytes()


def test_trace_store_uses_the_resilience_repair():
    assert p_store.repair_jsonl_tail is p_jsonl.repair_jsonl_tail


def _record(run_id):
    return p_store.TraceRecord(
        schema_version=p_store.SCHEMA_VERSION, run_id=run_id, timestamp=1.0,
        git_sha="x", config="c", machine="cpu-host", mesh={}, host={},
        phases={"fwd": {"wall_s": 0.1}})


def test_torn_tail_fires_on_the_sweep_store_only(tmp_path, fault_env):
    from repro.trace import store as r_store
    fault_env("torn_tail:sweep")
    trace = p_store.TraceStore(str(tmp_path / "trace.jsonl"))
    sweep = p_store.TraceStore(str(tmp_path / "sweep.jsonl"))
    assert sweep._store_kind == "sweep" and trace._store_kind == "trace"
    trace.append(_record("t1"))
    with pytest.raises(faults.InjectedFault, match="torn append"):
        sweep.append(_record("s1"))
    raw = (tmp_path / "sweep.jsonl").read_bytes()
    assert raw and not raw.endswith(b"\n")          # half a line, durable
    assert sweep.records() == []                    # the torn line skipped
    sweep.append(_record("s2"))                     # fired once: repaired
    assert [r.run_id for r in sweep.records()] == ["s2"]
    assert [r.run_id for r in trace.records()] == ["t1"]
    # the reference reads what the port's repaired store holds
    assert [r.run_id for r in r_store.TraceStore(sweep.path).records()] \
        == ["s2"]


def test_torn_tail_without_a_store_fires_on_any(tmp_path, fault_env):
    fault_env("torn_tail")
    store = p_store.TraceStore(str(tmp_path / "trace.jsonl"))
    with pytest.raises(faults.InjectedFault):
        store.append(_record("t1"))
    store.append(_record("t2"))
    assert [r.run_id for r in store.records()] == ["t2"]


# --------------------------------------------------------------------------
# journal
# --------------------------------------------------------------------------

EVENTS = [
    ("attempt", dict(sweep="s", point="k1", label="a", attempt=0)),
    ("attempt", dict(sweep="s", point="k2", label="b", attempt=0)),
    ("fail", dict(sweep="s", point="k1", label="a", attempt=0,
                  reason="boom")),
    ("done", dict(sweep="s", point="k2", label="b", attempt=0,
                  run_id="r2")),
    ("attempt", dict(sweep="s", point="k1", label="a", attempt=1)),
    ("fail", dict(sweep="s", point="k1", label="a", attempt=1,
                  reason="boom")),
    ("quarantine", dict(sweep="s", point="k1", label="a", attempt=1,
                        reason="boom")),
    ("attempt", dict(sweep="s", point="k3", label="c", attempt=0)),
    ("fail", dict(sweep="s", point="k3", label="c", attempt=0,
                  reason="hung")),
    ("attempt", dict(sweep="other", point="k9", label="z", attempt=0)),
    ("done", dict(sweep="other", point="k9", label="z", attempt=0,
                  run_id="r9", extra_field=3)),
]


def _log_all(journal):
    for event, kw in EVENTS:
        journal.log(event, **kw)


def test_journal_lines_equal_reference_but_the_time(tmp_path):
    from repro.resilience.journal import CampaignJournal as RJournal
    paths = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in ("port", "ref")}
    _log_all(CampaignJournal(paths["port"]))
    _log_all(RJournal(paths["ref"]))
    lines = {}
    for pkg, path in paths.items():
        with open(path) as f:
            lines[pkg] = [json.loads(ln) for ln in f]
    assert len(lines["port"]) == len(EVENTS)
    for a, b in zip(lines["port"], lines["ref"]):
        assert list(a) == list(b)                   # keys in one order
        a.pop("ts"), b.pop("ts")
        assert a == b


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_replay_and_summary_equal_reference(tmp_path, writer):
    from repro.resilience.journal import CampaignJournal as RJournal
    path = str(tmp_path / "sweep_journal.jsonl")
    _log_all(CampaignJournal(path) if writer == "port" else RJournal(path))
    with open(path, "a") as f:
        f.write('{"event": "done", "sweep": "s", "point": "k3", "ru')
    port, ref = CampaignJournal(path), RJournal(path)
    for sweep in ("s", "other", "none"):
        assert port.replay(sweep).__dict__ == ref.replay(sweep).__dict__
        assert port.summary(sweep) == ref.summary(sweep)
    state = port.replay("s")
    assert state.done == {"k2": "r2"} and state.quarantined == {"k1": "boom"}
    assert state.attempts == {"k1": 2, "k2": 1, "k3": 1}
    assert "k3" not in state.done                   # the torn done skipped


def test_journal_rejects_unknown_events_and_sits_beside_the_store(tmp_path):
    from repro.resilience.journal import journal_path_for as r_path
    with pytest.raises(ValueError, match="unknown journal event"):
        CampaignJournal(str(tmp_path / "j.jsonl")).log(
            "started", sweep="s", point="k")
    store = str(tmp_path / "ws" / "sweep.jsonl")
    assert journal_path_for(store) == r_path(store) == str(
        tmp_path / "ws" / "sweep_journal.jsonl")


# --------------------------------------------------------------------------
# supervised pool (module-level jobs: spawned workers import them)
# --------------------------------------------------------------------------

def _double(x):
    return 2 * x


def _boom(x):
    raise ValueError(f"boom {x}")


def _exit13(x):
    faults.parse_plan("crash_point:0").maybe_crash("crash_point", target=0,
                                                   attempt=0)
    return x


def _sleep(secs):
    import time
    time.sleep(secs)
    return secs


def test_pool_rejects_zero_workers():
    with pytest.raises(ValueError, match="n_workers"):
        SupervisedPool(_double, 0)


def test_pool_ok_and_error_outcomes():
    with SupervisedPool(_double, 1) as pool:
        out = pool.run([("a", (3,)), ("b", (4,))])
        spawned = pool._spawns
        assert out["a"].ok and out["a"].value == 6 and out["b"].value == 8
        assert pool.run([("c", (5,))])["c"].value == 10
        assert pool._spawns == spawned              # warm worker reused
    with SupervisedPool(_boom, 1) as pool:
        out = pool.run([("x", (1,))])["x"]
        assert out.kind == "ok" and out.value is None
        assert "ValueError: boom 1" in out.error


def test_pool_crash_reports_exit_code_and_replaces_the_worker():
    events = []
    with SupervisedPool(_exit13, 1) as pool:
        out = pool.run([("x", (1,)), ("y", (2,))],
                       on_event=lambda kind, tid: events.append((kind, tid)))
    assert out["x"].kind == "crash" and out["y"].kind == "crash"
    assert f"exit code {faults.CRASH_EXIT_CODE}" in out["x"].error
    assert events == [("crash", "x"), ("crash", "y")]
    assert pool.replacements == 2


def test_pool_kills_a_hung_task_at_its_deadline():
    import time
    # the deadline also bounds a worker's start-up (spawn, then torch's
    # import), so it stays well above that
    with SupervisedPool(_sleep, 1, deadline_s=15.0) as pool:
        t0 = time.monotonic()
        out = pool.run([("hang", (600,)), ("quick", (0,))])
        assert time.monotonic() - t0 < 60
        assert out["hang"].kind == "timeout"
        assert "deadline" in out["hang"].error
        assert out["quick"].ok and out["quick"].value == 0
        assert pool.replacements == 1
