"""The port's campaign engine against the reference's ``repro.sweep``.

* ``SweepSpec.expand()``: the same points, the same content-hash keys and
  the same skips for the same spec; spec JSON written by one package is
  read by the other; the registry selectors agree.
* ``run_sweep``: one small pooled campaign in each package under the plan
  ``crash_point:0x-1`` journals the same events, and each package resumes
  the other's campaign; analytical points are cached; a measured smoke
  point runs inline on the host, its FLOPs and bytes those of its meta
  walk; a mesh point fails with a reason and does not raise.
* ``aggregate``: summary rows, the ranked table, the gallery and the
  tune-provenance flags equal the reference's on one set of stored
  records that both packages read.
* the CLI's exit codes.

The reference runs with ``REPRO_WORKSPACE`` pinned to a temporary root, so
it reads no tune store of the checkout.
"""

import dataclasses
import json
import os
import re

import pytest

from repro_torch import cli
from repro_torch.configs import registry as p_registry
from repro_torch.resilience.faults import FAULT_ENV
from repro_torch.session.session import Session
from repro_torch.sweep import aggregate as p_agg
from repro_torch.sweep import engine as p_engine
from repro_torch.sweep import spec as p_spec
from repro_torch.trace.store import TraceStore

SMALL = dict(configs=("glm4-9b", "mamba2-1.3b"), seqs=(16,), batches=(2,))


@pytest.fixture(autouse=True)
def workspace_env(tmp_path, monkeypatch):
    root = tmp_path / "ws"
    monkeypatch.setenv("REPRO_WORKSPACE", str(root))
    monkeypatch.delenv(FAULT_ENV, raising=False)
    return root


def _specs():
    from repro.sweep import spec as r_spec
    yield "smoke", p_spec.smoke_spec(), r_spec.smoke_spec()
    axes = dict(name="grid", configs=("family:ssm", "all", "deepcam"),
                seqs=(16, 32), batches=(3, 4), amps=("O1", "O3"),
                fusions=("off", "static", "bogus"),
                meshes=((1, 1), (2, 4), (3, 1), (0, 1)), machine="tpu-v5e",
                measure=False, smoke=False, iters=2, warmup=0)
    yield "grid", p_spec.SweepSpec(**axes), r_spec.SweepSpec(**axes)


def _points(points):
    return [(p.to_dict(), p.key, p.label, p.n_devices) for p in points]


@pytest.mark.parametrize("which", ["smoke", "grid"])
def test_expand_equals_reference(which):
    _, port, ref = next(x for x in _specs() if x[0] == which)
    (pp, ps), (rp, rs) = port.expand(), ref.expand()
    assert _points(pp) == _points(rp) and pp
    assert [(p.to_dict(), p.key, why) for p, why in ps] == \
        [(p.to_dict(), p.key, why) for p, why in rs]
    if which == "grid":
        reasons = {why.split(" ")[0] for _, why in ps}
        assert reasons >= {"unknown", "bad", "global"}
    from repro.sweep import spec as r_spec
    assert {k: [p.key for p in v] for k, v in
            p_spec.points_by_devices(pp).items()} == \
        {k: [p.key for p in v] for k, v in
         r_spec.points_by_devices(rp).items()}


def test_spec_json_crosses_the_packages():
    from repro.sweep import spec as r_spec
    for _, port, ref in _specs():
        assert r_spec.SweepSpec.from_json(port.to_json()) == ref
        assert p_spec.SweepSpec.from_json(ref.to_json()) == port
    alias = {"name": "m", "mesh_shapes": ["1x1", [2, 4]], "seqs": [8]}
    assert p_spec.SweepSpec.from_dict(dict(alias)).meshes == \
        r_spec.SweepSpec.from_dict(dict(alias)).meshes == ((1, 1), (2, 4))
    for bad in ({"meshes": [[1, 1]], "mesh_shapes": ["1x1"]},
                {"bogus_axis": 1}):
        with pytest.raises(ValueError):
            p_spec.SweepSpec.from_dict(dict(bad))
    assert p_spec.parse_mesh("2X4") == r_spec.parse_mesh("2X4") == (2, 4)
    with pytest.raises(ValueError, match="DxM"):
        p_spec.parse_mesh("2x4x1")
    assert p_spec.parse_int_list("2, 4,,8") == r_spec.parse_int_list(
        "2, 4,,8") == (2, 4, 8)


@pytest.mark.parametrize("selectors", [
    ("all",), ("family:ssm",), ("family:moe", "glm4-9b"), ("deepcam",),
    ("zamba2-1.2b", "all", "deepcam", "zamba2-1.2b")])
def test_select_many_equals_reference(selectors):
    from repro.configs import registry as r_registry
    assert p_registry.select_many(selectors) == \
        r_registry.select_many(selectors)
    for name in p_registry.select_many(selectors):
        assert p_registry.family_of(name) == r_registry.family_of(name)


def test_select_rejects_unknown_names_and_families():
    for bad in ("nope", "family:nope"):
        with pytest.raises(KeyError):
            p_registry.select(bad)


def _events(path):
    with open(path) as f:
        return [(e["event"], e["point"], e["attempt"])
                for e in map(json.loads, f)]


def test_pooled_crash_journals_equal_and_each_package_resumes_the_other(
        tmp_path, monkeypatch):
    """The plan ``crash_point:0x-1`` in both packages (one worker each):
    point 0's worker exits hard twice and the point is quarantined, point
    1 lands; the journals hold the same (event, point, attempt) sequence.
    Then each package resumes the other's campaign: point 1 is skipped,
    point 0 lands, one record a point."""
    from repro.sweep import engine as r_engine
    from repro.sweep import spec as r_spec
    monkeypatch.setenv(FAULT_ENV, "crash_point:0x-1")
    kw = dict(name="chaos", measure=False, **SMALL)
    runs = {}
    for pkg, spec_cls, run_sweep in (
            ("port", p_spec.SweepSpec, p_engine.run_sweep),
            ("ref", r_spec.SweepSpec, r_engine.run_sweep)):
        store = str(tmp_path / pkg / "sweep.jsonl")
        res = run_sweep(spec_cls(**kw), store_path=store, workers=1,
                        cache_dir=str(tmp_path / pkg / "cache"),
                        retries=1, backoff_s=0.0)
        runs[pkg] = (res, store)
        assert res.n_ok == 1 and res.n_quarantined == 1
        assert res.results[0].quarantined and res.results[0].attempts == 2
        assert "exit code 13" in res.results[0].error
    assert _events(tmp_path / "port" / "sweep_journal.jsonl") == \
        _events(tmp_path / "ref" / "sweep_journal.jsonl")
    monkeypatch.delenv(FAULT_ENV)
    # each package resumes the campaign the other journalled
    for resumer, spec_cls, run_sweep, writer in (
            ("port", p_spec.SweepSpec, p_engine.run_sweep, "ref"),
            ("ref", r_spec.SweepSpec, r_engine.run_sweep, "port")):
        store = runs[writer][1]
        again = run_sweep(spec_cls(**kw), store_path=store, workers=0,
                          resume=True,
                          cache_dir=str(tmp_path / writer / "cache"))
        assert again.n_ok == 2 and again.n_resumed == 1, resumer
        assert again.results[1].resumed and not again.results[0].resumed
        keys = [r.meta["sweep_point"] for r in TraceStore(store).records()]
        assert sorted(keys) == sorted(p.key for p in
                                      p_spec.SweepSpec(**kw).expand()[0])


def test_analytical_points_are_cached_and_match_the_reference_payloads(
        tmp_path):
    store = str(tmp_path / "sweep.jsonl")
    spec = p_spec.SweepSpec(name="ana", measure=False, **SMALL)
    first = p_engine.run_sweep(spec, store_path=store, workers=0)
    second = p_engine.run_sweep(spec, store_path=store, workers=0)
    assert first.n_ok == 2 and first.n_cached == 0
    assert second.n_cached == 2
    recs = TraceStore(store).records()
    assert [r.meta["cached"] for r in recs] == [False, False, True, True]
    for a, b in zip(recs[:2], recs[2:]):
        assert a.phases == b.phases and a.meta["sweep_point"] == \
            b.meta["sweep_point"]
        assert set(a.phases) == {"fwd", "bwd", "opt"}
        assert all(p["wall_s"] == 0 and p["bound_overlap_s"] > 0
                   for p in a.phases.values())
    # another torch build would miss: the cache key hashes the version
    p = spec.expand()[0][0]
    path = p_engine._cache_path(str(tmp_path / "c"), p)
    assert os.path.basename(path).startswith(p.key + "-")


def test_measured_smoke_point_inline_on_the_host(tmp_path):
    s = Session(device="cpu", workspace=str(tmp_path / "w"))
    spec = p_spec.SweepSpec(name="meas", configs=("granite-moe-1b-a400m",),
                            seqs=(16,), batches=(2,),
                            fusions=("off", "static"), iters=1, warmup=1)
    res = s.sweep(spec, workers=0)
    assert res.kind == "sweep" and res.exit_code == 0
    assert res.data.n_ok == 2 and "granite-moe" in res.text
    ana = s.sweep(dataclasses.replace(spec, name="ana", measure=False),
                  workers=0)
    assert ana.exit_code == 0
    by = {(r.meta["fusion"], r.meta["measured"]): r
          for r in s.workspace.sweep_store.records()}
    for fusion in ("off", "static"):
        rec, twin = by[(fusion, True)], by[(fusion, False)]
        assert rec.meta["device"] == "cpu" and rec.machine == "cpu-host"
        assert set(rec.meta["kernel_configs"]) >= {"fused_norm",
                                                   "fused_adamw"}
        assert rec.meta["dispatch_table"] == {}
        for ph in ("fwd", "bwd", "opt"):
            assert rec.phases[ph]["wall_s"] > 0
            for k in ("flops", "hbm_bytes", "vmem_bytes", "launches"):
                assert rec.phases[ph][k] == twin.phases[ph][k], (fusion, ph,
                                                                 k)


def test_measured_sweep_without_the_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = p_spec.SweepSpec(name="m", **SMALL)
    with pytest.raises(RuntimeError, match="'cuda'"):
        p_engine.run_sweep(spec, store_path=str(tmp_path / "s.jsonl"),
                           workers=0)


def test_mesh_point_fails_with_its_reason_and_does_not_raise(tmp_path):
    spec = p_spec.SweepSpec(name="mesh", configs=("glm4-9b",), seqs=(16,),
                            batches=(2,), meshes=((2, 1),), measure=False)
    res = p_engine.run_sweep(spec, store_path=str(tmp_path / "s.jsonl"),
                             workers=0, retries=0)
    assert res.n_failed == 1 and res.results[0].quarantined
    assert "distributed/sharding.py" in res.failure_summary()[0]


def test_worker_pins_its_cards(monkeypatch):
    import torch
    assert p_engine._group_cards(None, 1) == ""
    assert p_engine._group_cards(torch.device("cpu"), 2) == ""
    assert p_engine._group_cards(torch.device("cuda", 1), 2) == "1,2"
    assert p_engine._group_cards(torch.device("cuda"), 1) == "0"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    p_engine._worker_init("")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""


# --------------------------------------------------------------------------
# aggregate: one store, both packages
# --------------------------------------------------------------------------

@pytest.fixture
def campaign(tmp_path):
    """A sweep store of measured (stamped) and analytical smoke points on
    the host, a tune store with one winner and a dispatch table, and two
    copies of a measured record whose stamps disagree with it."""
    root = tmp_path / "camp"
    s = Session(device="cpu", workspace=str(root))
    s.sweep(p_spec.SweepSpec(name="camp", configs=("glm4-9b",), seqs=(16,),
                             batches=(2,), fusions=("off", "static"),
                             iters=1, warmup=1), workers=0)
    s.sweep(p_spec.SweepSpec(name="camp", measure=False, **SMALL),
            workers=0)
    store = s.workspace.sweep_store
    rec = store.records()[0]
    for i, (src, impl) in enumerate((("tuned_available", "fused"),
                                     ("default", "reference"))):
        d = json.loads(rec.to_json())
        d["run_id"] = f"stamp{i}"
        d["meta"]["kernel_configs"]["fused_swiglu"] = {"source": src,
                                                       "entries": []}
        d["meta"]["dispatch_table"] = {
            "site-a": {"op": "rmsnorm", "impl": impl},
            "site-b": {"op": "swiglu", "impl": "fused"}}
        with open(store.path, "a") as f:
            f.write(json.dumps(d) + "\n")
    from repro_torch.tune.store import TuneStore
    TuneStore(s.workspace.tune_path).put_many({
        "fused_norm|cuda|16x64|float32|cpu-host": {
            "schema_version": 1, "key": "fused_norm|cuda|16x64|float32|"
            "cpu-host", "kernel": "fused_norm", "backend": "cuda",
            "shape": [16, 64], "dtype": "float32", "machine": "cpu-host",
            "params": {"threads": 128}, "timestamp": 1.0}})
    TuneStore(s.workspace.tune_path).put_dispatch_many({
        "site-a": {"schema_version": 1, "op": "rmsnorm", "impl": "fused",
                   "timestamp": 1.0}})
    return s.workspace


def _norm_cmd(text):
    return re.sub(r"`[^`]*`", "`CMD`", text)


def test_aggregate_equals_reference_on_one_store(campaign):
    from repro.sweep import aggregate as r_agg
    from repro.trace.store import TraceStore as RStore
    p_recs = p_agg.sweep_records(campaign.sweep_store, "camp")
    r_recs = r_agg.sweep_records(RStore(campaign.sweep_path), "camp")
    assert [r.run_id for r in p_recs] == [r.run_id for r in r_recs]
    assert len(p_recs) == 6
    p_last, r_last = p_agg.latest_per_point(p_recs), \
        r_agg.latest_per_point(r_recs)
    assert list(p_last) == list(r_last)
    assert p_agg.summary_rows(p_recs) == r_agg.summary_rows(r_recs)
    assert p_agg.render_summary(p_last) == r_agg.render_summary(r_last)
    assert p_agg.gallery(p_last, max_charts=2) == \
        r_agg.gallery(r_last, max_charts=2)
    assert p_agg.kernel_config_lines(p_recs) == \
        r_agg.kernel_config_lines(r_recs)
    assert p_agg.tune_mismatch_rows(p_recs, campaign.tune_path) == \
        r_agg.tune_mismatch_rows(r_recs, campaign.tune_path)
    flags = p_agg.tune_mismatches(p_recs, campaign.tune_path)
    assert [_norm_cmd(f) for f in flags] == \
        [_norm_cmd(f) for f in r_agg.tune_mismatches(r_recs,
                                                     campaign.tune_path)]
    kinds = {row["kind"] for row in
             p_agg.tune_mismatch_rows(p_recs, campaign.tune_path)}
    assert kinds == {"stale_default", "vanished_tuned", "dispatch_changed",
                     "dispatch_vanished"}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_sweep_cli_exit_codes(tmp_path, capsys):
    store = str(tmp_path / "cli" / "sweep.jsonl")
    run = ["sweep", "run", "--store", store, "--configs", "glm4-9b",
           "--seq", "16", "--batch", "2", "--workers", "0"]
    assert cli.main(run + ["--no-measure", "--name", "c"]) == 0
    out = capsys.readouterr().out
    assert "1 point(s)" in out and "1 ok (0 cached)" in out
    assert cli.main(run + ["--no-measure", "--name", "c", "--resume"]) == 0
    assert "1 resumed" in capsys.readouterr().out
    assert cli.main(["sweep", "report", "--store", store, "--name", "c",
                     "--charts", "1"]) == 0
    assert "markers:" in capsys.readouterr().out
    assert cli.main(["sweep", "report", "--store", store,
                     "--name", "none"]) == 2
    assert cli.main(run + ["--faults", "crash_point"]) == 2
    assert cli.main(run + ["--configs", "nope"]) == 2
    assert cli.main(["sweep", "run", "--smoke", "--seq", "8"]) == 2
    assert cli.main(["sweep", "--help"]) == 0
    assert cli.main(run + ["--no-measure", "--mesh", "2x1", "--retries",
                           "0", "--name", "mesh"]) == 1
    import torch
    if not torch.cuda.is_available():
        assert cli.main(run + ["--name", "m"]) == 2       # no card
        assert "'cuda' was asked for" in capsys.readouterr().err
    assert cli.main(run + ["--name", "m", "--device", "cpu", "--iters",
                           "1", "--warmup", "1"]) == 0


def test_tune_flags_read_each_record_under_its_own_machine(campaign):
    """A point measured under the machine key ``h100-sxm`` while winners
    for that key existed is current: the port's report checks it under
    its own key, where the reference's reads ``cpu-host`` and flags it."""
    from repro.sweep import aggregate as r_agg
    from repro_torch.tune.store import TuneStore
    rec = p_agg.sweep_records(campaign.sweep_store, "camp")[0]
    d = json.loads(rec.to_json())
    d.update(run_id="card0", machine="h100-sxm")
    d["meta"]["kernel_configs"] = {"fused_swiglu": {
        "source": "tuned_available", "entries": []}}
    d["meta"].pop("dispatch_table")
    card = type(rec).from_dict(d)
    TuneStore(campaign.tune_path).put_many({"fused_swiglu|h100": {
        "schema_version": 1, "key": "fused_swiglu|h100", "kernel":
        "fused_swiglu", "machine": "h100-sxm", "timestamp": 2.0}})
    assert p_agg.tune_mismatch_rows([card], campaign.tune_path) == []
    assert [r["kind"] for r in r_agg.tune_mismatch_rows(
        [card], campaign.tune_path)] == ["vanished_tuned"]
    assert [r["kind"] for r in p_agg.tune_mismatch_rows(
        [card], campaign.tune_path, machine="cpu-host")] == \
        ["vanished_tuned"]
