"""The port's operational smokes on the host (``repro_torch.bench``:
``trace_smoke``, ``sweep_smoke``, ``tune_smoke``, ``dispatch_smoke``,
``session_smoke``, ``obs_smoke``, ``chaos_smoke``) and the standalone
trace entry (``python -m repro_torch.trace``).

* Each smoke runs with ``device="cpu"``, passes its own assertions and
  emits the reference's row names (``benchmarks/*.py``); the sweep rows
  carry the reference's point labels.
* The deterministic parts are held here: the injected regressions
  flagged, the second tune and dispatch searches all store hits, the
  analysis cache's hit, the chaos journal, the train leg's bit-for-bit
  resume and ``chaos_report.json`` at the workspace root.  A timing gate
  is held on a fixed timer (``obs_smoke``'s trend gate: every timed call
  takes 5 ms, the 2× record 10 ms), because the test run shares the
  host's cores; ``sweep_smoke``'s cache hit beats the cold walk by more
  than an order of magnitude on this host, so its own timing check
  stays.
* ``python -m repro_torch.trace record`` writes a record that the
  reference's ``repro.trace.store`` reads, and ``compare`` flags a
  ``--scale-wall 2`` run; ``--help`` lists the three subcommands.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro.sweep.spec import SweepSpec as RSweepSpec
from repro.trace import store as r_store
from repro_torch.bench import __main__ as bench_main
from repro_torch.bench import chaos_smoke, sweep_smoke
from repro_torch.core import profiler
from repro_torch.trace import cli as trace_cli

SMOKES = ("trace_smoke", "sweep_smoke", "tune_smoke", "dispatch_smoke",
          "session_smoke", "obs_smoke", "chaos_smoke")


def _sweep_labels() -> list[str]:
    """The reference's labels of sweep_smoke's measured points."""
    spec = RSweepSpec(name="bench", configs=sweep_smoke.CONFIGS, seqs=(16,),
                      batches=(2,), amps=("O1",), meshes=((1, 1),),
                      machine="cpu-host", measure=True, smoke=True)
    return [p.label for p in spec.expand()[0]]


#: the reference's row names per smoke (``benchmarks/*.py``)
REF_ROWS = {
    "trace_smoke": ["minitron-4b/fwd", "minitron-4b/bwd", "minitron-4b/opt",
                    "compare_cells", "injected_regression_flagged"],
    "sweep_smoke": [*_sweep_labels(), "cache_cold", "cache_warm"],
    "tune_smoke": ["triad_best", "triad_default", "triad_second_search",
                   "ert_gemm_best", "ert_gemm_default",
                   "ert_gemm_second_search"],
    "dispatch_smoke": ["search_first", "search_second", "table"],
    "session_smoke": ["characterize", "profile", "record", "report",
                      "sweep", "tune", "compare", "workspace_files"],
    "obs_smoke": ["merge", "trend_gate_ok", "trend_gate_regress", "advise",
                  "rules_fired"],
    "chaos_smoke": ["sweep_chaos", "sweep_resume", "train_crash_resume",
                    "train_transient_retry", "ckpt_fail_prompt",
                    "torn_tail_repair"],
}


def _fixed_samples(fn, args, *, iters=10, warmup=3):
    """Every timed call takes 5 ms; the callable still runs once."""
    return [0.005] * max(iters, 1), fn(*args)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the
    host's cores (as ``test_torch_bench.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smokes(tmp_path_factory):
    """Every smoke on the host in one fresh workspace (``obs_smoke`` on
    the fixed timer); the workspace root is returned beside."""
    ws = str(tmp_path_factory.mktemp("ws"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_WORKSPACE", ws)
        res = bench_main.run([s for s in SMOKES if s != "obs_smoke"], "cpu")
        mp.setattr(profiler, "time_samples", _fixed_samples)
        res |= bench_main.run(["obs_smoke"], "cpu")
    return res, ws


def _rows(res, suite) -> dict:
    return {n.split("/", 1)[1]: d for n, _, d in res[suite]["rows"]}


@pytest.mark.parametrize("suite", SMOKES)
def test_smoke_runs_on_the_host_with_the_reference_rows(smokes, suite):
    res, _ = smokes
    assert res[suite]["ok"]
    assert [n for n, _, _ in res[suite]["rows"]] == \
        [f"{suite}/{n}" for n in REF_ROWS[suite]]


def test_trace_smoke_flags_every_cell(smokes):
    rows = _rows(smokes[0], "trace_smoke")
    assert rows["compare_cells"] == "9"
    assert rows["injected_regression_flagged"].startswith("9 cells past 10%")


def test_tune_and_dispatch_second_searches_are_store_hits(smokes):
    rows = _rows(smokes[0], "tune_smoke")
    assert rows["triad_second_search"] == rows["ert_gemm_second_search"] \
        == "store_hit"
    rows = _rows(smokes[0], "dispatch_smoke")
    first = dict(kv.split("=") for kv in rows["search_first"].split(";"))
    second = dict(kv.split("=") for kv in rows["search_second"].split(";"))
    assert int(first["measured"]) == int(first["sites"]) > 0
    assert second["measured"] == "0" and second["cached"] == "True"


def test_session_and_obs_smokes_keep_one_root(smokes):
    rows = _rows(smokes[0], "session_smoke")
    assert set(rows["workspace_files"].split(";")) >= {
        "sweep.jsonl", "trace.jsonl", "tune.json", "workspace.json"}
    rows = _rows(smokes[0], "obs_smoke")
    assert rows["merge"] == "added=1"
    assert rows["trend_gate_ok"] == "exit=0"
    assert rows["trend_gate_regress"].startswith("exit=1;")
    assert rows["rules_fired"]


def test_chaos_report_lands_at_the_workspace_root(smokes):
    res, ws = smokes
    with open(os.path.join(ws, "chaos_report.json")) as f:
        report = json.load(f)
    assert report["train"]["bit_identical"] is True
    assert report["train"]["resumed_from"] == 4
    assert len(report["sweep_after_chaos"]["quarantined"]) == 1
    assert not report["sweep_after_resume"]["quarantined"]
    assert _rows(res, "chaos_smoke")["sweep_resume"] == "2resumed"
    assert chaos_smoke.SWEEP_DEADLINE_S == 30.0


def test_chaos_child_refuses_a_missing_card(tmp_path):
    """The train child takes the suite's device and fails without it,
    never falling back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the child would train on it")
    import repro_torch
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(repro_torch.__file__)),
         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.chaos_smoke",
         "--train-child", str(tmp_path / "ck"), "--steps", "1",
         "--device", "cuda"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and "CHAOS_FINAL" not in out.stdout
    assert "finds no CUDA device" in out.stderr
    assert not (tmp_path / "ck").exists()


def test_trace_entry_records_for_the_reference_store(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(profiler, "time_samples", _fixed_samples)
    store = str(tmp_path / "t.jsonl")
    common = ["--device", "cpu", "--store", store]
    run = ["--config", "minitron-4b", "--seq", "16", "--batch", "2",
           "--iters", "1", "--warmup", "1", *common]
    assert trace_cli.main(["report", *common]) == 2     # nothing stored yet
    assert trace_cli.main(["record", *run]) == 0
    assert trace_cli.main(["compare", *common]) == 0    # one run only
    assert trace_cli.main(["record", "--scale-wall", "2", *run]) == 0
    assert trace_cli.main(["compare", *common]) == 1
    assert trace_cli.main(["report", "--config", "minitron-4b",
                           *common]) == 0
    assert "[report] minitron-4b" in capsys.readouterr().out
    assert trace_cli.main(["record", *common]) == 2      # no --config
    recs = r_store.TraceStore(store).records("minitron-4b")
    assert len(recs) == 2
    assert recs[1].phases["fwd"]["wall_s"] == \
        pytest.approx(2 * recs[0].phases["fwd"]["wall_s"])
    assert {r.meta["scale_wall"] for r in recs} == {1.0, 2.0}


def test_trace_module_entry_lists_its_subcommands():
    out = subprocess.run([sys.executable, "-m", "repro_torch.trace",
                          "--help"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    assert "{record,compare,report}" in out.stdout
