"""chaos_smoke: the resilience layer end to end, under injected faults
(port of ``benchmarks/chaos_smoke.py``).

Two legs, each asserting that a faulted run converges to the *same
bytes* as a fault-free one:

* **sweep** — a 3-point analytical campaign runs once fault-free (the
  baseline), then again under an injected plan: point 0's worker crashes
  on its first attempt, point 1 hangs past the per-point deadline (killed
  and replaced by the watchdog), point 2 crashes on *every* attempt and
  is quarantined.  A final ``resume`` pass with the plan cleared skips the
  two completed points through the campaign journal and finishes the
  quarantined one.  It asserts exactly one record per point key (no
  duplicates across three invocations), phase payloads byte-identical to
  the baseline, and the quarantine in the journal's summary.
* **train** — a 12-step smoke train loop runs uninterrupted in a child
  process (the reference loss), then a sibling child is crashed at step
  5 by ``crash_step`` and a third child resumes from the last verified
  checkpoint: its final loss must equal the reference's bit for bit
  (float hex).  The children train on the suite's device and fail, never
  fall back to the host, when it is missing; on the card each runs under
  deterministic algorithms with cuBLAS's workspace fixed, set in its own
  environment before its first product.  In-process legs cover
  transient step faults retried with backoff (losses again bitwise
  equal), a checkpoint-write fault surfaced promptly through
  ``AsyncCheckpointer.healthy()``, and a torn-tail store append repaired
  on the next write.

The journal summaries land in ``chaos_report.json`` at the root of the
port workspace (``REPRO_WORKSPACE``, else ``./.repro-workspace`` in a
checkout, else ``~/.repro``).

Run: ``python -m repro_torch.bench --only chaos_smoke [--device cpu]``;
the child entry is ``python -m repro_torch.bench.chaos_smoke
--train-child CKPT_DIR [--steps N] [--device D]``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from repro_torch.bench.common import Row, datasheet
from repro_torch.core.machine import CPU_HOST

SWEEP_CONFIGS = ("minitron-4b", "mamba2-1.3b", "glm4-9b")
TRAIN_STEPS = 12
CRASH_AT = 5
#: sweep chaos plan: point 0 crashes once, point 1 hangs (far past the
#: deadline) once, point 2 crashes on every attempt → quarantine
SWEEP_PLAN = "crash_point:0;hang_point:1:600x1;crash_point:2x-1"
SWEEP_DEADLINE_S = 30.0
#: cuBLAS's fixed workspace, which deterministic algorithms need on the
#: card before the first product (``launch.train`` sets the same)
CUBLAS_WORKSPACE = ":4096:8"

_FINAL_RE = re.compile(
    r"CHAOS_FINAL steps=(\d+) loss=(\S+) resumed_from=(\S+)")


@contextlib.contextmanager
def _fault_env(value: str | None):
    """Temporarily set or clear ``REPRO_FAULTS`` (a suite must not leak a
    fault plan into later suites)."""
    from repro_torch.resilience.faults import FAULT_ENV
    prev = os.environ.get(FAULT_ENV)
    try:
        if value is None:
            os.environ.pop(FAULT_ENV, None)
        else:
            os.environ[FAULT_ENV] = value
        yield
    finally:
        if prev is None:
            os.environ.pop(FAULT_ENV, None)
        else:
            os.environ[FAULT_ENV] = prev


def _phases_bytes(rec) -> str:
    return json.dumps(rec.phases, sort_keys=True)


def _sweep_spec(name: str, machine: str):
    from repro_torch.sweep.spec import SweepSpec
    return SweepSpec(name=name, configs=SWEEP_CONFIGS, seqs=(16,),
                     batches=(2,), amps=("O1",), meshes=((1, 1),),
                     machine=machine, measure=False, smoke=True)


def _run_sweep_leg(rows: list[Row], report: dict, machine: str) -> None:
    from repro_torch.resilience.journal import (CampaignJournal,
                                                journal_path_for)
    from repro_torch.sweep.engine import run_sweep
    from repro_torch.trace.store import TraceStore

    with tempfile.TemporaryDirectory() as d:
        base_store = os.path.join(d, "baseline", "sweep.jsonl")
        chaos_store = os.path.join(d, "chaos", "sweep.jsonl")

        # fault-free baseline, inline: the byte-identity reference
        with _fault_env(None):
            base = run_sweep(_sweep_spec("chaos", machine),
                             store_path=base_store, workers=0,
                             cache_dir=None)
        assert base.n_ok == 3 and base.n_failed == 0, \
            base.failure_summary()
        base_phases = {r.meta["sweep_point"]: _phases_bytes(r)
                       for r in TraceStore(base_store).records()}

        # chaos pass: crash + hang + poison point, one supervised worker
        t0 = time.time()
        with _fault_env(SWEEP_PLAN):
            chaos = run_sweep(_sweep_spec("chaos", machine),
                              store_path=chaos_store, workers=1,
                              cache_dir=None, deadline_s=SWEEP_DEADLINE_S,
                              retries=1, backoff_s=0.1)
        t_chaos = time.time() - t0
        assert chaos.n_ok == 2 and chaos.n_quarantined == 1, \
            (chaos.n_ok, chaos.n_quarantined, chaos.failure_summary())
        by_idx = dict(enumerate(chaos.results))
        assert by_idx[0].ok and by_idx[0].attempts == 2, \
            "point 0 must survive its injected crash on retry"
        assert by_idx[1].ok and by_idx[1].attempts == 2, \
            "point 1 must survive its deadline kill on retry"
        assert by_idx[2].quarantined and by_idx[2].attempts == 2

        journal = CampaignJournal(journal_path_for(chaos_store))
        reasons = [e.get("reason", "") for e in journal.entries("chaos")
                   if e["event"] == "fail"]
        assert any("deadline" in r for r in reasons), reasons
        report["sweep_after_chaos"] = journal.summary("chaos")
        assert len(report["sweep_after_chaos"]["quarantined"]) == 1

        # resume with the plan cleared: skip the done, finish the poisoned
        t0 = time.time()
        with _fault_env(None):
            final = run_sweep(_sweep_spec("chaos", machine),
                              store_path=chaos_store, workers=1,
                              cache_dir=None, resume=True,
                              deadline_s=SWEEP_DEADLINE_S, retries=1)
        t_resume = time.time() - t0
        assert final.n_ok == 3 and final.n_failed == 0, \
            final.failure_summary()
        assert final.n_resumed == 2, \
            "the two completed points must be skipped, not re-run"
        report["sweep_after_resume"] = journal.summary("chaos")
        assert not report["sweep_after_resume"]["quarantined"]

        # zero duplicates across three invocations; bytes match baseline
        recs = TraceStore(chaos_store).records()
        keys = [r.meta["sweep_point"] for r in recs]
        assert len(keys) == 3 and len(set(keys)) == 3, \
            f"expected exactly one record per point, got {keys}"
        for r in recs:
            assert _phases_bytes(r) == base_phases[r.meta["sweep_point"]], \
                f"{r.meta['label']}: chaos phases differ from baseline"

        rows.append(("chaos_smoke/sweep_chaos", t_chaos * 1e6,
                     "crash+hang+quarantine"))
        rows.append(("chaos_smoke/sweep_resume", t_resume * 1e6,
                     f"{final.n_resumed}resumed"))


def _train_child_cmd(ckpt_dir: str, device: str) -> list[str]:
    return [sys.executable, "-m", "repro_torch.bench.chaos_smoke",
            "--train-child", ckpt_dir, "--steps", str(TRAIN_STEPS),
            "--device", device]


def _run_child(ckpt_dir: str, fault: str | None, device: str):
    import repro_torch
    from repro_torch.resilience.faults import FAULT_ENV
    env = dict(os.environ)
    env.pop(FAULT_ENV, None)
    if fault:
        env[FAULT_ENV] = fault
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    return subprocess.run(_train_child_cmd(ckpt_dir, device), env=env,
                          capture_output=True, text=True, timeout=600)


def _parse_final(proc) -> tuple[int, str, str]:
    m = _FINAL_RE.search(proc.stdout)
    assert m, f"no CHAOS_FINAL line in child output:\n{proc.stdout}\n" \
              f"{proc.stderr}"
    return int(m.group(1)), m.group(2), m.group(3)


def _run_train_leg(rows: list[Row], report: dict, device: str) -> None:
    from repro_torch.resilience.faults import CRASH_EXIT_CODE

    with tempfile.TemporaryDirectory() as d:
        # reference: uninterrupted child
        t0 = time.time()
        ref = _run_child(os.path.join(d, "ref"), None, device)
        assert ref.returncode == 0, ref.stderr
        ref_steps, ref_loss, ref_resumed = _parse_final(ref)
        assert ref_steps == TRAIN_STEPS and ref_resumed == "None"

        # crash at step 5, then resume from the last checkpoint
        crash_dir = os.path.join(d, "crash")
        crashed = _run_child(crash_dir, f"crash_step:{CRASH_AT}", device)
        assert crashed.returncode == CRASH_EXIT_CODE, \
            (crashed.returncode, crashed.stderr)
        resumed = _run_child(crash_dir, None, device)
        assert resumed.returncode == 0, resumed.stderr
        res_steps, res_loss, res_resumed = _parse_final(resumed)
        assert res_resumed != "None", "second child must resume, not restart"
        assert res_loss == ref_loss, \
            (f"resumed loss {res_loss} != uninterrupted {ref_loss} "
             "(bitwise float hex)")
        t_train = time.time() - t0
        report["train"] = {"steps": TRAIN_STEPS, "crash_at": CRASH_AT,
                           "resumed_from": int(res_resumed),
                           "loss_hex": ref_loss, "bit_identical": True}
        rows.append(("chaos_smoke/train_crash_resume", t_train * 1e6,
                     f"resume@{res_resumed};loss={ref_loss[:10]}"))


def _smoke_trainer_parts():
    """(model, run, stream) of the train leg: granite-8b's smoke config,
    seq 32, batch 8, O1."""
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import api as M

    cfg = get_smoke("granite-8b")
    return (M.build(cfg), RunConfig(amp="O1"),
            TokenStream(cfg, ShapeSpec("t", 32, 8, "train"), batch=8))


def _run_inprocess_legs(rows: list[Row], report: dict, device: str) -> None:
    from repro_torch.resilience.faults import InjectedFault
    from repro_torch.train.trainer import Trainer
    from repro_torch.trace.store import TraceStore, record_from_payloads

    model, run, stream = _smoke_trainer_parts()
    quiet = lambda *_: None  # noqa: E731

    # transient step faults: retried past, losses bitwise unchanged
    with _fault_env(None):
        clean = Trainer(model, run, stream, lr=1e-3, device=device).fit(
            6, log_every=0, log=quiet)
    t0 = time.time()
    with _fault_env("step_fault:3x2"):
        faulted = Trainer(model, run, stream, lr=1e-3, device=device).fit(
            6, log_every=0, log=quiet)
    t_retry = time.time() - t0
    assert faulted.retries == 2, faulted.retries
    assert [x.hex() for x in faulted.losses] == \
           [x.hex() for x in clean.losses], \
        "retried losses must be bit-identical to the fault-free run"
    rows.append(("chaos_smoke/train_transient_retry", t_retry * 1e6,
                 f"{faulted.retries}retries;bitwise-equal"))

    # checkpoint-write fault: healthy() surfaces it at the log interval
    with tempfile.TemporaryDirectory() as d, _fault_env("ckpt_fail:4"):
        t = Trainer(model, run, stream, ckpt_dir=d, ckpt_every=4, lr=1e-3,
                    device=device)
        try:
            t.fit(TRAIN_STEPS, log_every=1, log=quiet)
        except InjectedFault:
            pass
        else:
            raise AssertionError("injected ckpt_fail never surfaced")
        assert t.report.steps < TRAIN_STEPS, \
            "a dead checkpointer must fail the run promptly, not at the end"
    rows.append(("chaos_smoke/ckpt_fail_prompt", 0.0,
                 f"failed@step{t.report.steps}<{TRAIN_STEPS}"))

    # torn-tail append: injected torn write, repaired on the next append
    with tempfile.TemporaryDirectory() as d:
        store = TraceStore(os.path.join(d, "trace.jsonl"))

        def mk(name):
            return record_from_payloads(name, {"fwd": {"wall_s": 1.0}},
                                        machine="cpu-host")

        with _fault_env(None):
            store.append(mk("a"))
        with _fault_env("torn_tail:trace"):
            try:
                store.append(mk("b"))
            except InjectedFault:
                pass
            else:
                raise AssertionError("torn_tail never fired")
        with _fault_env(None):
            store.append(mk("c"))
            got = [r.config for r in store.records()]
        assert got == ["a", "c"], got
    rows.append(("chaos_smoke/torn_tail_repair", 0.0, "dropped=1;kept=2"))
    report["inprocess"] = {"transient_retries": faulted.retries,
                           "torn_tail": "repaired"}


def _report_path() -> str:
    from repro_torch.session.workspace import Workspace
    return os.path.join(Workspace().root, "chaos_report.json")


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    # the child's device: inside it, its first visible card
    child_dev = "cuda" if dev.type == "cuda" else "cpu"
    rows: list[Row] = []
    report: dict = {}
    _run_sweep_leg(rows, report, datasheet(dev, host=CPU_HOST).name)
    _run_train_leg(rows, report, child_dev)
    _run_inprocess_legs(rows, report, dev)
    path = _report_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    print(f"# chaos report -> {path}", file=sys.stderr)
    return rows


def _train_child(ckpt_dir: str, steps: int, device: str) -> int:
    """Child-process entry: run (or resume) the smoke train loop on
    ``device`` (raising, not falling back, when it is missing) and print
    the bit-exact final loss.  An injected ``crash_step`` exits hard with
    ``CRASH_EXIT_CODE`` before this prints anything."""
    from repro_torch.device import resolve_device
    from repro_torch.train.trainer import Trainer

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True, warn_only=True)
    model, run, stream = _smoke_trainer_parts()
    t = Trainer(model, run, stream, ckpt_dir=ckpt_dir, ckpt_every=4,
                lr=1e-3, device=dev)
    rep = t.fit(steps, log_every=0, log=lambda *_: None)
    print(f"CHAOS_FINAL steps={int(t.state.step)} "
          f"loss={rep.losses[-1].hex()} resumed_from={rep.resumed_from}")
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.chaos_smoke",
        description="the chaos suite's train child (the suite itself runs "
                    "through python -m repro_torch.bench --only chaos_smoke)")
    ap.add_argument("--train-child", required=True, metavar="CKPT_DIR")
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    sys.exit(_train_child(args.train_child, args.steps, args.device))
