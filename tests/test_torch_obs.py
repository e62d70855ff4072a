"""The port's observability layer against the reference's ``repro.obs``.

* trend: the series (keys, values, evidence), the sparklines, the gate's
  verdicts with the rolling and the pinned baseline and the report equal
  the reference's on one workspace both packages read;
* advisor: each rule's findings (rule, subject, severity, evidence; the
  remediations name each package's own commands) equal the reference's;
  ``dispatch_stale`` reads the ``torch`` key the port's dispatch table
  stamps;
* merge: the reports and the merged stores equal the reference's, each
  package merging the other's workspace;
* the workspace header (tags, merges) read by both; ``Session.compare``
  with ``base`` / ``new`` and ``window``; the CLI's exit codes.

Records are measured on the host at the smoke size with a fixed timer
(5 ms a call), so a regression is the injected ``scale_wall`` and nothing
else.
"""

import json
import os
import shutil

import pytest

from repro_torch import cli
from repro_torch.core import profiler
from repro_torch.obs import advisor as p_adv
from repro_torch.obs import merge as p_merge
from repro_torch.obs import trend as p_trend
from repro_torch.session.session import Session
from repro_torch.session.workspace import Workspace

SMOKE = dict(seq=16, batch=2, iters=1, warmup=1)


@pytest.fixture(autouse=True)
def workspace_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_WORKSPACE", str(tmp_path / "default"))


@pytest.fixture
def fixed_timer(monkeypatch):
    def samples(fn, args, *, iters=10, warmup=3):
        return [0.005] * max(iters, 1), fn(*args)
    monkeypatch.setattr(profiler, "time_samples", samples)


def _bench(root, stamp, ts, wall, us):
    os.makedirs(root, exist_ok=True)
    doc = {"schema_version": 1, "timestamp": ts, "host": {"host": "h1"},
           "suites": {"ert_ladder": {"ok": True, "wall_s": wall, "rows": [
               {"name": "fp32", "us_per_call": us, "derived": ""},
               {"name": "derived_only", "us_per_call": 0.0,
                "derived": "x"}]},
               "broken": {"ok": False, "wall_s": 1.0, "rows": []}}}
    with open(os.path.join(root, f"BENCH_{stamp}.json"), "w") as f:
        json.dump(doc, f)


@pytest.fixture
def history(tmp_path, fixed_timer):
    """Four glm4-9b records (the third tagged, the fourth at 2x wall), a
    static one, and three bench harvests (one corrupt)."""
    s = Session(device="cpu", workspace=str(tmp_path / "hist"))
    runs = [s.record("glm4-9b", **SMOKE).data.run_id for _ in range(3)]
    s.trend_tag("good", runs[-1])
    runs.append(s.record("glm4-9b", scale_wall=2.0, **SMOKE).data.run_id)
    s.record("glm4-9b", fusion="static", **SMOKE)
    bench = s.workspace.bench_dir
    _bench(bench, "20260101T000000Z", 1.0, 2.0, 10.0)
    _bench(bench, "20260102T000000Z", 2.0, 2.1, 30.0)
    with open(os.path.join(bench, "BENCH_20260103T000000Z.json"), "w") as f:
        f.write("{corrupt")
    return s, runs


def _series(series):
    return [(s.key, s.source, s.metric, s.lower_is_better,
             [(p.timestamp, p.value, p.ref) for p in s.points])
            for s in series]


def _regs(regs):
    return [(r.series.key, r.series.metric, r.baseline, r.rel,
             r.baseline_ref) for r in regs]


def test_trend_equals_reference(history):
    from repro.obs import trend as r_trend
    from repro.session.workspace import Workspace as RWorkspace
    s, runs = history
    ps = p_trend.collect_series(s.workspace)
    rs = r_trend.collect_series(RWorkspace(s.workspace.root))
    assert _series(ps) == _series(rs)
    assert {x.source for x in ps} == {"trace", "bench"}
    assert [p_trend.sparkline(x.values) for x in ps] == \
        [r_trend.sparkline(x.values) for x in rs]
    for tol in (0.25, 5.0):
        pg, rg = p_trend.gate_series(ps, tol), r_trend.gate_series(rs, tol)
        assert _regs(pg) == _regs(rg)
        assert p_trend.render_trend(ps, pg) == r_trend.render_trend(rs, rg)
    pin = s.workspace.resolve_tag("good")
    assert pin == runs[2]
    pg = p_trend.gate_series(ps, baseline_run=pin)
    assert _regs(pg) == _regs(r_trend.gate_series(rs, baseline_run=pin))
    assert [r.series.metric for r in pg] == ["wall_s"]
    assert pg[0].baseline_ref == f"run {runs[2]}" and pg[0].rel == \
        pytest.approx(1.0)
    def point(p):
        return None if p is None else (p.timestamp, p.value, p.ref)
    for x, y in zip(ps, rs):
        assert point(p_trend.pinned_baseline(x, pin[:6])) == \
            point(r_trend.pinned_baseline(y, pin[:6]))
    assert p_trend.render_trend(ps, max_rows=3) == \
        r_trend.render_trend(rs, max_rows=3)
    assert p_trend.sparkline([]) == "" and p_trend.sparkline([2, 2]) == \
        r_trend.sparkline([2, 2])


def test_session_trend_gate_and_tag(history):
    s, runs = history
    res = s.trend()
    assert res.kind == "trend" and res.exit_code == 0
    assert s.trend(gate=True).exit_code == 1
    assert s.trend(gate=True, baseline="good").exit_code == 1
    assert s.trend(gate=True, tolerance=5.0).exit_code == 0
    assert s.trend(gate=True, baseline=runs[3]).exit_code == 0
    tag = s.trend_tag("newest")
    assert tag.data["run_id"] == s.workspace.trace_store.last(n=1)[0].run_id
    with pytest.raises(LookupError):
        s.trend_tag("x", run_id="nope")


def test_default_bench_dirs_are_the_workspace_and_the_ones_passed(history,
                                                                 tmp_path):
    s, _ = history
    assert p_trend.default_bench_dirs(s.workspace) == [s.workspace.bench_dir]
    extra = tmp_path / "extra"
    _bench(str(extra), "20260105T000000Z", 5.0, 9.0, 99.0)
    with_extra = p_trend.collect_series(s.workspace,
                                        bench_dirs=[str(extra)])
    wall = next(x for x in with_extra if x.key == "ert_ladder|h1"
                and x.metric == "wall_s")
    assert len(wall.points) == 3
    empty = Workspace(str(tmp_path / "empty"))
    assert p_trend.collect_series(empty) == []
    assert "no history yet" in p_trend.render_trend([])


# --------------------------------------------------------------------------
# advisor
# --------------------------------------------------------------------------

def _rec(run_id, ts, config="glm4-9b", *, phases, meta=None, mesh=None,
         host=None, sha="sha-a"):
    return {"schema_version": 1, "run_id": run_id, "timestamp": ts,
            "git_sha": sha, "config": config, "machine": "cpu-host",
            "mesh": mesh or {}, "host": host or {"host": "h1",
                                                 "torch": "2.9"},
            "phases": phases, "meta": meta or {}}


def _phase(wall, *, flops=1e6, hbm=1e6, vmem=1e6, launches=100, zero=40,
           scatter=0, compute=1e-5, memory=1e-5, ici=0.0, dcn=0.0):
    return {"launches": launches, "zero_ai_launches": zero,
            "scatter_launches": scatter, "wall_s": wall, "iters": 1,
            "achieved_flops_per_s": flops / wall if wall else 0.0,
            "pct_of_roofline": 0.0, "bound_overlap_s": max(compute, memory),
            "bound_serial_s": compute + memory, "compute_s": compute,
            "memory_s": memory, "collective_s": ici + dcn,
            "dominant": "memory", "flops": flops, "hbm_bytes": hbm,
            "vmem_bytes": vmem, "ici_bound_s": ici, "dcn_bound_s": dcn,
            "kernels": []}


@pytest.fixture
def advised(tmp_path):
    """A workspace whose records trip every rule but ``dispatch_stale``."""
    root = tmp_path / "adv"
    ws = Workspace(str(root)).ensure()
    default = {k: {"source": "default", "params": {}} for k in
               ("fused_norm", "fused_adamw")}
    trace = [
        _rec("aaaaaaaaaaa1", 1.0, "granite-8b", phases={
            "fwd": _phase(0.01), "bwd": _phase(0.02, scatter=12)}),
        _rec("aaaaaaaaaaa2", 2.0, phases={
            "fwd": _phase(0.01, hbm=1.5e8), "opt": _phase(0.004,
                                                          zero=2)},
             meta={"kernel_configs": default}),
        _rec("aaaaaaaaaaa3", 3.0, "serve/glm4-9b",
             phases={"decode": _phase(0.01, hbm=1.5e8)},
             meta={"n_slots": 2}),
        _rec("aaaaaaaaaaa4", 4.0, "serve/glm4-9b",
             phases={"decode": _phase(0.04, hbm=1.5e8)},
             meta={"n_slots": 8}),
        _rec("aaaaaaaaaaa5", 5.0, "minitron-4b", phases={
            "fwd": _phase(0.01, ici=0.5, dcn=0.1)},
            mesh={"data": 2, "model": 4},
            meta={"kernel_configs": {"fused_norm": {
                "source": "tuned_available", "entries": []}},
                "dispatch_table": {"s1": {"op": "rmsnorm", "impl": "fused"}}}),
    ]
    with open(ws.trace_path, "w") as f:
        for d in trace:
            f.write(json.dumps(d) + "\n")
    with open(ws.sweep_path, "w") as f:
        f.write(json.dumps(_rec("bbbbbbbbbbb1", 6.0, "mamba2-1.3b", phases={
            "fwd": _phase(0.0, ici=0.2)}, mesh={"data": 8, "model": 1},
            meta={"sweep_point": "k", "sweep": "s"})) + "\n")
    return ws


def _findings(findings, rule=None):
    out = []
    for f in findings:
        if rule and f.rule != rule:
            continue
        ev = f.evidence[:1] if f.rule == "network_bound" else f.evidence
        out.append((f.rule, f.subject, f.severity, ev))
    return out


def test_advise_equals_reference(advised):
    from repro.obs import advisor as r_adv
    from repro.session.workspace import Workspace as RWorkspace
    p = p_adv.advise(advised)
    r = r_adv.advise(RWorkspace(advised.root))
    assert _findings(p) == _findings(r)
    assert {f.rule for f in p} == set(p_adv.RULES) - {"dispatch_stale"}
    assert p_adv.RULES == r_adv.RULES
    for f in p:
        assert all(("run " in e) for e in f.evidence[:1])
        assert "python -m repro " not in f.remediation
    assert _findings(p_adv.advise(advised, config="glm4-9b")) == \
        _findings(r_adv.advise(RWorkspace(advised.root), config="glm4-9b"))
    text = p_adv.render_findings(p, top=2)
    assert text.startswith(f"advise: {len(p)} finding(s)")
    assert "raise --top" in text
    assert "no known bottleneck" in p_adv.render_findings([])


def test_tune_mismatch_rule_against_another_machine_key(advised):
    from repro.obs import advisor as r_adv
    from repro_torch.tune.store import TuneStore
    TuneStore(advised.tune_path).put_many({"k": {
        "schema_version": 1, "key": "k", "kernel": "fused_norm",
        "backend": "cuda", "machine": "box", "timestamp": 1.0}})
    recs = advised.trace_store.records()
    for machine in ("box", "cpu-host"):
        assert _findings(p_adv.rule_tune_mismatch(
            recs, advised.tune_path, machine=machine)) == _findings(
            r_adv.rule_tune_mismatch(recs, advised.tune_path,
                                     machine=machine))
    assert {f.subject.split("/")[-1] for f in p_adv.rule_tune_mismatch(
        recs, advised.tune_path, machine="box")} >= {"fused_norm"}
    assert p_adv.rule_untuned(recs, advised.tune_path, machine="box") == []


def test_dispatch_stale_reads_the_torch_stamp():
    from repro.obs import advisor as r_adv
    from repro_torch.trace.store import TraceRecord
    entry = {"op": "rmsnorm", "impl": "fused", "git_sha": "sha-a",
             "torch": "2.1.0"}
    stale = TraceRecord.from_dict(_rec("ccccccccccc1", 1.0, phases={},
                                       meta={"dispatch_table": {"s": entry}}))
    found = p_adv.rule_dispatch_stale([stale])
    assert [f.rule for f in found] == ["dispatch_stale"]
    assert "torch 2.1.0 vs 2.9" in found[0].evidence[0]
    assert "run ccccccccccc1" in found[0].evidence[0]
    # the reference reads a "jax" key the port's table does not stamp
    assert r_adv.rule_dispatch_stale([stale]) == []
    same = TraceRecord.from_dict(_rec("ccccccccccc2", 1.0, phases={}, meta={
        "dispatch_table": {"s": dict(entry, torch="2.9")}}))
    assert p_adv.rule_dispatch_stale([same]) == []
    moved = TraceRecord.from_dict(_rec("ccccccccccc3", 1.0, phases={},
                                       sha="sha-b", meta={
        "dispatch_table": {"s": dict(entry, torch="2.9")}}))
    assert "git sha-a vs sha-b" in p_adv.rule_dispatch_stale(
        [moved])[0].evidence[0]


def test_dispatch_table_stamps_the_torch_version(tmp_path):
    from repro_torch.tune.dispatch import active_dispatch_table
    from repro_torch.tune.store import TuneStore
    TuneStore(str(tmp_path / "t.json")).put_dispatch_many({"s": {
        "schema_version": 1, "key": "s", "op": "rmsnorm", "impl": "fused",
        "machine": "cpu-host", "torch_version": "2.9", "timestamp": 1.0}})
    table = active_dispatch_table("cpu-host", str(tmp_path / "t.json"))
    assert table["s"]["torch"] == "2.9"


# --------------------------------------------------------------------------
# merge
# --------------------------------------------------------------------------

def _remote(root):
    """A workspace to merge: records (one a duplicate of the local's, one a
    conflict), a corrupt line and a newer-schema line, tune winners (one
    newer, one older than the local's), a dispatch entry, bench files (one
    corrupt) and a header."""
    ws = Workspace(str(root)).ensure()
    lines = [json.dumps(_rec("dup000000001", 1.0, phases={})),
             json.dumps(_rec("conflict0001", 2.0, phases={"fwd": {}})),
             "{corrupt", json.dumps(dict(_rec("newer0000001", 3.0, phases={}),
                                         schema_version=99)),
             json.dumps(_rec("fresh0000001", 4.0, phases={})),
             json.dumps({k: v for k, v in _rec("", 5.0, phases={}).items()
                         if k != "run_id"})]
    with open(ws.trace_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(ws.sweep_path, "w") as f:
        f.write(json.dumps(_rec("sweep0000001", 6.0, phases={})) + "\n")
    with open(ws.tune_path, "w") as f:
        json.dump({"schema_version": 1, "records": {
            "k1": {"kernel": "a", "timestamp": 5.0},
            "k2": {"kernel": "b", "timestamp": 1.0},
            "k3": {"kernel": "c", "timestamp": 1.0}, "bad": 3},
            "dispatch": {"s1": {"op": "rmsnorm", "impl": "fused",
                                "timestamp": 2.0}}}, f)
    _bench(ws.bench_dir, "20260101T000000Z", 1.0, 2.0, 10.0)
    _bench(ws.bench_dir, "20260102T000000Z", 2.0, 2.0, 10.0)
    with open(os.path.join(ws.bench_dir, "BENCH_20260103T000000Z.json"),
              "w") as f:
        f.write("{")
    with open(ws.header_path, "w") as f:
        json.dump({"schema_version": 1, "machine": "cpu-host",
                   "host": {"host": "remote"}, "git_sha": "r"}, f)
    return ws


def _local(root):
    ws = Workspace(str(root)).ensure()
    with open(ws.trace_path, "w") as f:
        f.write(json.dumps(_rec("dup000000001", 1.0, phases={})) + "\n")
        f.write(json.dumps(_rec("conflict0001", 2.0, phases={})) + "\n")
    with open(ws.tune_path, "w") as f:
        json.dump({"schema_version": 1, "records": {
            "k1": {"kernel": "a", "timestamp": 1.0},
            "k2": {"kernel": "b", "timestamp": 3.0}}, "dispatch": {}}, f)
    _bench(ws.bench_dir, "20260101T000000Z", 1.0, 2.0, 10.0)
    return ws


def _state(ws):
    out = {}
    for name in ("trace.jsonl", "sweep.jsonl"):
        path = os.path.join(ws.root, name)
        out[name] = open(path, "rb").read() if os.path.exists(path) else None
    with open(ws.tune_path) as f:
        out["tune"] = json.load(f)
    out["bench"] = sorted(os.listdir(ws.bench_dir))
    header = ws.read_header()
    out["merges"] = [{k: v for k, v in m.items()
                      if k not in ("timestamp", "remote_root")}
                     for m in header.get("merges", [])]
    return out


def _reports(reports):
    return [(r.store, r.n_added, r.n_dup, r.n_conflict, r.n_skipped,
             len(r.notes)) for r in reports]


@pytest.mark.parametrize("merger", ["port-into-port", "ref-into-port"])
def test_merge_equals_reference(tmp_path, merger):
    from repro.obs import merge as r_merge
    from repro.session.workspace import Workspace as RWorkspace
    remote = _remote(tmp_path / "remote")
    p_local, r_local = _local(tmp_path / "p"), _local(tmp_path / "r")
    p_reps = p_merge.merge_workspace(p_local, remote.root)
    r_reps = r_merge.merge_workspace(RWorkspace(r_local.root), remote.root)
    assert _reports(p_reps) == _reports(r_reps)
    assert [r.describe().splitlines()[0] for r in p_reps] == \
        [r.describe().splitlines()[0] for r in r_reps]
    assert _state(p_local) == _state(r_local)
    assert _reports(p_reps) == [("trace", 2, 1, 1, 2, 3),
                                ("sweep", 1, 0, 0, 0, 0),
                                ("tune", 3, 0, 2, 1, 3),
                                ("bench", 1, 1, 0, 1, 1)]
    # a second merge adds nothing and leaves the header alone
    again = p_merge.merge_workspace(p_local, remote.root)
    assert sum(r.n_added for r in again) == 0
    assert len(p_local.read_header()["merges"]) == 1
    # each package merges a workspace the other merged into
    src = r_local if merger == "ref-into-port" else p_local
    fresh = Workspace(str(tmp_path / "fresh"))
    reps = p_merge.merge_workspace(fresh, src.root)
    assert {r.store: r.n_added for r in reps} == {
        "trace": 4, "sweep": 1, "tune": 4, "bench": 2}
    assert "total: 11" in p_merge.render_merge(reps, fresh.root, src.root)
    back = r_merge.merge_workspace(RWorkspace(str(tmp_path / "back")),
                                   fresh.root)
    assert sum(r.n_added for r in back) == 11


def test_merge_of_a_missing_root_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        p_merge.merge_workspace(Workspace(str(tmp_path / "l")),
                                str(tmp_path / "nope"))


# --------------------------------------------------------------------------
# workspace, compare, CLI
# --------------------------------------------------------------------------

def test_workspace_header_tags_and_merges_cross_the_packages(tmp_path):
    from repro.session.workspace import Workspace as RWorkspace
    port, ref = Workspace(str(tmp_path)), RWorkspace(str(tmp_path))
    for attr in ("trace_path", "sweep_path", "journal_path",
                 "sweep_cache_dir", "tune_path", "header_path", "bench_dir"):
        assert getattr(port, attr) == getattr(ref, attr)
    assert port.store_paths() == ref.store_paths()
    port.tag_run("good", "abc123")
    assert ref.resolve_tag("good") == "abc123" and ref.tags() == port.tags()
    ref.tag_run("old", "def456")
    port.record_merge({"remote_root": "/x", "added": {"trace": 1}})
    assert port.resolve_tag("old") == "def456"
    assert port.resolve_tag("other") == "other"
    port.write_header("cpu-host")                 # keeps tags and merges
    header = ref.read_header()
    assert header["schema_version"] == 1 and set(header["tags"]) == \
        {"good", "old"}
    assert len(header["merges"]) == 1
    assert header["stores"] == {"trace": "trace.jsonl",
                                "sweep": "sweep.jsonl", "tune": "tune.json"}
    assert port.describe().splitlines()[0] == ref.describe().splitlines()[0]


def test_compare_base_new_and_window_equal_reference(tmp_path, fixed_timer):
    from repro.session import Session as RSession
    from repro.session.workspace import Workspace as RWorkspace
    s = Session(device="cpu", workspace=str(tmp_path / "cmp"))
    a = s.record("glm4-9b", **SMOKE).data.run_id
    b = s.record("glm4-9b", scale_wall=1.5, **SMOKE).data.run_id
    c = s.record("glm4-9b", scale_wall=1.02, **SMOKE).data.run_id
    r = RSession(machine="cpu-host", workspace=RWorkspace(s.workspace.root))

    def cells(res):
        return [(d.config, d.phase, d.metric, d.base, d.new, d.regression)
                for d in res.data]
    for kw in (dict(base=a[:6], new=b), dict(base=b, new=c, threshold=0.3),
               dict(window=3), dict(window=2), dict(config="glm4-9b")):
        p_res, r_res = s.compare(**kw), r.compare(**kw)
        assert cells(p_res) == cells(r_res) and p_res.exit_code == \
            r_res.exit_code
    assert s.compare(base=a, new=b).exit_code == 1
    assert s.compare(window=2).exit_code == 0
    with pytest.raises(ValueError):
        s.compare(base=a)
    with pytest.raises(LookupError):
        s.compare(base=a, new="nope")


def test_obs_cli_exit_codes(history, tmp_path, capsys):
    s, runs = history
    ws = ["--device", "cpu", "--workspace", s.workspace.root]
    assert cli.main(["trend", *ws]) == 0
    assert cli.main(["trend", "--gate", *ws]) == 1
    assert "regression(s) past tolerance" in capsys.readouterr().out
    assert cli.main(["trend", "--gate", "--tolerance", "5", *ws]) == 0
    assert cli.main(["trend", "tag", *ws]) == 2
    assert cli.main(["trend", "tag", "mine", "--run", runs[0], *ws]) == 0
    assert cli.main(["trend", "--gate", "--baseline", "mine", *ws]) == 1
    assert cli.main(["trend", "tag", "x", "--run", "nope", *ws]) == 2
    assert cli.main(["advise", "--top", "1", *ws]) == 0
    assert "advise:" in capsys.readouterr().out
    assert cli.main(["merge", str(tmp_path / "nope"), *ws]) == 2
    other = str(tmp_path / "other")
    assert cli.main(["merge", s.workspace.root, "--device", "cpu",
                     "--workspace", other]) == 0
    assert "total:" in capsys.readouterr().out
    store = ["--device", "cpu", "--store", s.workspace.trace_path]
    assert cli.main(["compare", *store, "--base", runs[0], "--new",
                     runs[3]]) == 1
    assert cli.main(["compare", *store, "--base", runs[0]]) == 2
    assert cli.main(["compare", *store, "--window", "3", "--threshold",
                     "5"]) == 0
    shutil.rmtree(other)
