"""The port's network level (``repro_torch.net``) held against the
reference's (``repro.net``) on the host.

The pure functions (ring wire bytes, payloads, the alpha-beta fit) equal
the reference's on hypothesis-drawn inputs; the same rows fitted and
stored by either package give the same tune records and ceilings, and
each package reads the other's ``tune.json``; the machine with its net
ceilings folded in, the report rows, flip lines and the rendered report
equal the reference's over one stored sweep; the reference's own
``tests/test_net.py`` cases run over the port.  ``characterize_net``
measures on 4 gloo ranks of the host (smoke sizes), then hits its
store; a card's key on a host with too few cards raises before any rank
starts and stores nothing.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.net import characterize as R_C
from repro.net import collectives as R_NC
from repro.net import report as R_NR
from repro_torch.net import characterize as C
from repro_torch.net import collectives as NC
from repro_torch.net import report as NR
from repro_torch.net.collectives import (fit_ceiling, payload_bytes,
                                         wire_bytes)

SETTINGS = dict(max_examples=100, deadline=None)


# --------------------------------------------------------------------------
# ring wire-byte formulas and the fit, against the reference
# --------------------------------------------------------------------------

def test_constants_equal_reference():
    assert NC.OPS == R_NC.OPS and NC.LEGS == R_NC.LEGS
    assert (C.NET_BACKEND, C.NET_DTYPE, C.SUMMARY_SHAPE) == \
        (R_C.NET_BACKEND, R_C.NET_DTYPE, R_C.SUMMARY_SHAPE)
    assert (C.DEFAULT_SIZES, C.SMOKE_SIZES, C.DEFAULT_DEVICES) == \
        (R_C.DEFAULT_SIZES, R_C.SMOKE_SIZES, R_C.DEFAULT_DEVICES)


@given(op=st.sampled_from(NC.OPS + ("collective-broadcast",)),
       payload=st.floats(0, 1e12, allow_nan=False),
       n=st.integers(-2, 4096))
@settings(**SETTINGS)
def test_wire_bytes_equal_reference(op, payload, n):
    assert wire_bytes(op, payload, n) == R_NC.wire_bytes(op, payload, n)


@given(op=st.sampled_from(NC.OPS), elems=st.integers(0, 1 << 30),
       n=st.integers(1, 4096), itemsize=st.sampled_from((1, 2, 4, 8)))
@settings(**SETTINGS)
def test_payload_bytes_equal_reference(op, elems, n, itemsize):
    assert payload_bytes(op, elems, n, itemsize) == \
        R_NC.payload_bytes(op, elems, n, itemsize)


@given(st.lists(st.tuples(st.floats(1.0, 1e10, allow_nan=False),
                          st.floats(1e-7, 10.0, allow_nan=False)),
                min_size=1, max_size=12))
@settings(**SETTINGS)
def test_fit_ceiling_equal_reference(samples):
    assert fit_ceiling(samples) == R_NC.fit_ceiling(samples)


def _counted_ring_bytes(op, payload, n):
    """The per-link chunk traffic of a ring algorithm, counted hop by
    hop (the reference's oracle)."""
    n = max(n, 2)
    chunk = payload / n
    hops = 2 * (n - 1) if op == "all_reduce" else (n - 1)
    return sum(chunk for _ in range(hops))


class TestWireFormulas:
    """The reference's ``TestWireFormulas`` over the port."""

    def test_all_reduce_multiplier(self):
        assert wire_bytes("all_reduce", 100.0, 4) == pytest.approx(150.0)

    def test_one_pass_multiplier(self):
        for op in ("all_gather", "reduce_scatter", "all_to_all"):
            assert wire_bytes(op, 100.0, 4) == pytest.approx(75.0)

    def test_group_floor(self):
        assert wire_bytes("all_reduce", 100.0, 1) == \
            wire_bytes("all_reduce", 100.0, 2)

    def test_all_gather_payload_is_output_sized(self):
        assert payload_bytes("all_gather", 16, 4) == 16 * 4 * 4
        assert payload_bytes("all_reduce", 16, 4) == 16 * 4

    @given(st.integers(1, 1 << 20), st.integers(2, 64),
           st.sampled_from((1, 2, 4, 8)))
    @settings(**SETTINGS)
    def test_property_wire_matches_counted_reference(self, elems, n, isz):
        for op in NC.OPS:
            pay = payload_bytes(op, elems, n, itemsize=isz)
            assert wire_bytes(op, pay, n) == \
                pytest.approx(_counted_ring_bytes(op, pay, n))

    @given(st.integers(1, 1 << 20), st.integers(2, 64))
    @settings(**SETTINGS)
    def test_property_all_reduce_is_twice_one_pass(self, elems, n):
        pay = float(elems * 4)
        assert wire_bytes("all_reduce", pay, n) == pytest.approx(
            2 * wire_bytes("reduce_scatter", pay, n))

    @given(st.integers(1, 128))
    @settings(**SETTINGS)
    def test_property_mirrors_the_op_walk_multipliers(self, n):
        from repro_torch.core.op_analysis import _COLL_MULT
        assert wire_bytes("all_reduce", 1.0, n) == pytest.approx(
            _COLL_MULT["all-reduce"](max(n, 2)))
        assert wire_bytes("all_gather", 1.0, n) == pytest.approx(
            _COLL_MULT["all-gather"](max(n, 2)))


class TestFitCeiling:
    def test_recovers_exact_model(self):
        bw, lat = 2e9, 50e-6
        fbw, flat = fit_ceiling([(w, lat + w / bw)
                                 for w in (1e3, 1e4, 1e5, 1e6)])
        assert fbw == pytest.approx(bw, rel=1e-6)
        assert flat == pytest.approx(lat, rel=1e-6)

    def test_degenerate_slope_falls_back_to_best_throughput(self):
        bw, lat = fit_ceiling([(1e3, 1e-3), (1e6, 1e-3)])
        assert bw == pytest.approx(1e6 / 1e-3)
        assert lat == 0.0

    def test_empty_raises(self):
        with pytest.raises(ValueError):
            fit_ceiling([])


# --------------------------------------------------------------------------
# the tune store: persist → ceilings → machine spec, across the packages
# --------------------------------------------------------------------------

def _synthetic_rows(n_devices=8):
    """What measure_collectives returns, its times from a known model."""
    rows = []
    for leg in NC.LEGS:
        gsize = 2 if leg == "dcn" else n_devices
        for op in NC.OPS:
            for elems in (1024, 8192, 65536):
                pay = payload_bytes(op, elems, gsize)
                wire = wire_bytes(op, pay, gsize)
                bw = (4e9 if leg == "ici" else 1e9) * (1 + NC.OPS.index(op))
                rows.append({"leg": leg, "op": op, "group_size": gsize,
                             "elems": elems, "payload_bytes": pay,
                             "wire_bytes": wire,
                             "t_s": 10e-6 * (1 + NC.OPS.index(op))
                             + wire / bw})
    return rows


def _stores(tmp_path):
    from repro.tune.store import TuneStore as RStore
    from repro_torch.tune.store import TuneStore as PStore
    return PStore(str(tmp_path / "p.json")), RStore(str(tmp_path / "r.json"))


_VOLATILE = ("timestamp", "git_sha", "host", "library")


def _records(path):
    with open(path) as f:
        recs = json.load(f)["records"]
    return {k: {f: v for f, v in r.items() if f not in _VOLATILE}
            for k, r in recs.items()}


def test_fit_rows_equal_reference():
    rows = _synthetic_rows()
    assert C._fit_rows(rows) == R_C._fit_rows(rows)


def test_persist_writes_the_reference_records(tmp_path):
    p_store, r_store = _stores(tmp_path)
    rows = _synthetic_rows()
    p_ceil = C._persist(C._fit_rows(rows), "cpu-host", 8, (1024, 8192),
                        p_store)
    r_ceil = R_C._persist(R_C._fit_rows(rows), "cpu-host", 8,
                          (1024, 8192), r_store)
    strip = lambda c: {leg: {k: v for k, v in d.items()
                             if k not in ("timestamp", "git_sha")}
                       for leg, d in c.items()}
    assert strip(p_ceil) == strip(r_ceil)
    assert _records(p_store.path) == _records(r_store.path)
    assert set(_records(p_store.path)) == {
        f"net_{leg}_{op}|collective|8|float32|cpu-host"
        for leg in NC.LEGS for op in NC.OPS} | {
        f"net_{leg}|collective|0|float32|cpu-host" for leg in NC.LEGS}
    assert p_ceil["ici"]["bytes_per_s"] == pytest.approx(16e9, rel=1e-6)
    assert p_ceil["dcn"]["latency_s"] == pytest.approx(10e-6, rel=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_tune_json(tmp_path, writer):
    p_store, r_store = _stores(tmp_path)
    rows = _synthetic_rows()
    if writer == "port":
        C._persist(C._fit_rows(rows), "cpu-host", 8, (1024,), p_store)
        path = p_store.path
    else:
        R_C._persist(R_C._fit_rows(rows), "cpu-host", 8, (1024,), r_store)
        path = r_store.path
    from repro.tune.store import TuneStore as RStore
    from repro_torch.tune.store import TuneStore as PStore
    p_view = C.net_ceilings("cpu-host", PStore(path))
    r_view = R_C.net_ceilings("cpu-host", RStore(path))
    assert p_view == r_view and set(p_view) == {"ici", "dcn"}
    # and a characterize under that key is a store hit in either package
    assert C.characterize_net("cpu-host", store=PStore(path))["cached"]
    assert R_C.characterize_net("cpu-host", store=RStore(path))["cached"]


def _levels(spec):
    return [(lv.name, lv.bytes_per_s, lv.latency_s)
            for lv in spec.interconnect]


def test_machine_with_net_equals_reference(tmp_path):
    from repro.tune.store import TuneStore as RStore
    from repro_torch.tune.store import TuneStore as PStore
    p_store, _ = _stores(tmp_path)
    assert _levels(C.machine_with_net("cpu-host", p_store)) == \
        _levels(R_C.machine_with_net("cpu-host", RStore(p_store.path)))
    C._persist(C._fit_rows(_synthetic_rows()), "cpu-host", 8, (1024,),
               p_store)
    p_spec = C.machine_with_net("cpu-host", PStore(p_store.path))
    r_spec = R_C.machine_with_net("cpu-host", RStore(p_store.path))
    assert p_spec.net_levels and _levels(p_spec) == _levels(r_spec)
    assert p_spec.net_level("ici").bytes_per_s == pytest.approx(16e9,
                                                                rel=1e-6)


def test_with_empirical_net_keeps_levels_not_named():
    from repro_torch.core.machine import H100_SXM
    spec = H100_SXM.with_empirical_net({"dcn": 12e9}, {"dcn": 3e-6})
    assert spec.net_level("dcn").bytes_per_s == 12e9
    assert spec.net_level("dcn").latency_s == 3e-6
    assert spec.net_level("ici") == H100_SXM.net_level("ici")
    assert spec.peak_flops == H100_SXM.peak_flops


class TestStoreRoundTrip:
    """The reference's ``TestStoreRoundTrip`` over the port."""

    def _store(self, tmp_path):
        from repro_torch.tune.store import TuneStore
        return TuneStore(str(tmp_path / "tune.json"))

    def test_machine_without_store_is_datasheet(self, tmp_path):
        from repro_torch.core.machine import get_machine
        spec = C.machine_with_net("cpu-host", self._store(tmp_path))
        assert spec == get_machine("cpu-host") and not spec.net_levels

    def test_missing_leg_means_no_ceilings(self, tmp_path):
        store = self._store(tmp_path)
        fits = {k: v for k, v in C._fit_rows(_synthetic_rows()).items()
                if k[0] == "ici"}
        with pytest.raises(AssertionError):
            C._persist(fits, "cpu-host", 8, (1024,), store)
        assert C.net_ceilings("cpu-host", store) is None

    def test_odd_device_count_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="even"):
            C.characterize_net("cpu-host", n_devices=7,
                               store=self._store(tmp_path), force=True)

    def test_card_key_without_the_cards_raises_and_stores_nothing(
            self, tmp_path, monkeypatch):
        import repro_torch.distributed.ranks as ranks

        def no_ranks(*a, **k):
            raise AssertionError("a rank was started")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        monkeypatch.setattr(ranks, "launch", no_ranks)
        store = self._store(tmp_path)
        with pytest.raises(RuntimeError,
                           match="net characterize on h100-sxm needs 8 "
                                 "cards; this host has 0"):
            C.characterize_net("h100-sxm", n_devices=8, store=store,
                               inline=True)
        assert not os.path.exists(store.path)
        assert C.net_ceilings("h100-sxm", store) is None
        assert C.backend_for("h100-sxm") == "nccl"
        assert C.backend_for("cpu-host") == "gloo"


def test_characterize_on_four_gloo_ranks_then_a_store_hit(tmp_path):
    """Measured on 4 gloo ranks of the host (smoke sizes): every (leg,
    op) fitted, both legs positive, the dcn groups of 2; then a store hit
    that times nothing (the stored records unchanged)."""
    from repro_torch.tune.store import TuneStore
    store = TuneStore(str(tmp_path / "tune.json"))
    out = C.characterize_net("cpu-host", n_devices=4, smoke=True, iters=1,
                             store=store, inline=True, deadline_s=240)
    assert out["cached"] is False and out["n_devices"] == 4
    assert set(out["ceilings"]) == {"ici", "dcn"}
    assert all(c["bytes_per_s"] > 0 and c["n_devices"] == 4
               for c in out["ceilings"].values())
    assert {(leg, op) for leg, ops in out["ops"].items() for op in ops} == \
        {(leg, op) for leg in NC.LEGS for op in NC.OPS}
    with open(store.path) as f:
        recs = json.load(f)["records"]
    assert recs["net_dcn_all_reduce|collective|4|float32|cpu-host"][
        "params"]["group_size"] == 2
    assert recs["net_ici_all_reduce|collective|4|float32|cpu-host"][
        "params"]["group_size"] == 4
    again = C.characterize_net("cpu-host", n_devices=4, smoke=True,
                               store=store)
    assert again["cached"] is True and again["ops"] == {}
    with open(store.path) as f:
        assert json.load(f)["records"] == recs


# --------------------------------------------------------------------------
# report rows, flip lines and the rendered report, across the packages
# --------------------------------------------------------------------------

def _rec(config, mesh, compute_s, memory_s, ici_s, dcn_s=0.0,
         run_id="r0", ts=1.0, label=None):
    from repro_torch.trace.store import TraceRecord
    return TraceRecord(
        schema_version=1, run_id=run_id, timestamp=ts, git_sha="deadbeef",
        config=config, machine="cpu-host", mesh=dict(mesh),
        host={"host": "h"}, phases={"step": {
            "compute_s": compute_s, "memory_s": memory_s,
            "ici_bound_s": ici_s, "dcn_bound_s": dcn_s,
            "wall_s": 0.0, "net_bytes": (ici_s + dcn_s) * 1e9}},
        meta={"label": label} if label else {})


@pytest.fixture
def sweep_jsonl(tmp_path):
    """One stored sweep: two configs over three mesh shapes each."""
    from repro_torch.trace.store import TraceStore
    path = str(tmp_path / "sweep.jsonl")
    store = TraceStore(path)
    i = 0
    for cfg, scale in (("a", 1.0), ("b", 0.1)):
        for mesh, ici, dcn in (({"data": 1, "model": 1}, 0.0, 0.0),
                               ({"data": 1, "model": 8}, 5e-3, 0.0),
                               ({"data": 2, "model": 8}, 4e-3, 6e-3)):
            i += 1
            store.append(_rec(cfg, mesh, 1e-3, 4e-3 * scale / max(
                mesh["model"], 1) ** 0.5, ici * scale, dcn * scale,
                run_id=f"r{i}", ts=float(i), label=f"{cfg}/m{i}"))
    return path


def _both(path):
    from repro.trace.store import TraceStore as RStore
    from repro_torch.trace.store import TraceStore as PStore
    return PStore(path).records(), RStore(path).records()


def test_net_rows_and_flips_equal_reference(sweep_jsonl):
    p, r = _both(sweep_jsonl)
    assert [NR.net_row(x) for x in p] == [R_NR.net_row(x) for x in r]
    assert NR.net_rows(p) == R_NR.net_rows(r)
    assert NR.flip_lines(NR.net_rows(p)) == R_NR.flip_lines(R_NR.net_rows(r))
    assert len(NR.flip_lines(NR.net_rows(p))) == 2


def test_render_equals_reference_on_one_store(sweep_jsonl, tmp_path):
    from repro.tune.store import TuneStore as RStore
    from repro_torch.tune.store import TuneStore as PStore
    p, r = _both(sweep_jsonl)
    tune = str(tmp_path / "tune.json")
    # never characterized: the same text but the command the note names
    p_text = NR.render_net_report(p, machine="cpu-host", store=PStore(tune))
    r_text = R_NR.render_net_report(r, machine="cpu-host",
                                    store=RStore(tune))
    assert "python -m repro_torch net characterize" in p_text
    assert p_text.replace("repro_torch", "repro") == r_text
    # measured ceilings in the store: the same text
    C._persist(C._fit_rows(_synthetic_rows()), "cpu-host", 8, (1024,),
               PStore(tune))
    p_text = NR.render_net_report(p, machine="cpu-host", store=PStore(tune))
    assert p_text == R_NR.render_net_report(r, machine="cpu-host",
                                            store=RStore(tune))
    assert "measured, 8 device(s)" in p_text
    assert NR.render_net_report([], machine="cpu-host",
                                store=PStore(tune)) == \
        R_NR.render_net_report([], machine="cpu-host", store=RStore(tune))


def test_card_key_note_says_no_measurement_here(tmp_path, monkeypatch):
    from repro_torch.tune.store import TuneStore
    store = TuneStore(str(tmp_path / "tune.json"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    text = NR.ceilings_text("h100-sxm", store)
    assert "python -m repro_torch net characterize" in text
    assert "this host has 1 card(s)" in text
    assert "no measurement is possible here" in text
    assert "no measurement" not in NR.ceilings_text("cpu-host", store)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert "no measurement" not in NR.ceilings_text("h100-sxm", store)


class TestNetReport:
    """The reference's ``TestNetReport`` over the port."""

    def test_net_row_classifies_bound(self):
        row = NR.net_row(_rec("a", {"data": 1, "model": 8},
                              compute_s=1e-3, memory_s=2e-3, ici_s=5e-3))
        assert row["bound"] == "net" and row["n_devices"] == 8
        assert row["net_s"] == pytest.approx(5e-3)
        assert row["step_bound_s"] == pytest.approx(5e-3)

    def test_flip_detected_along_scale_axis(self):
        lines = NR.flip_lines(NR.net_rows([
            _rec("a", {"data": 1, "model": 1}, 1e-3, 4e-3, 0.0),
            _rec("a", {"data": 1, "model": 8}, 1e-3, 2e-3, 5e-3),
        ]))
        assert len(lines) == 1
        assert "flips" in lines[0] and "1x8" in lines[0]

    def test_never_network_bound(self):
        lines = NR.flip_lines(NR.net_rows([
            _rec("a", {}, 1e-3, 4e-3, 1e-4)]))
        assert "never network-bound" in lines[0]

    def test_render_includes_ceilings_and_ranking(self, tmp_path):
        from repro_torch.tune.store import TuneStore
        text = NR.render_net_report(
            [_rec("a", {"data": 1, "model": 8}, 1e-3, 2e-3, 5e-3)],
            machine="cpu-host", store=TuneStore(str(tmp_path / "t.json")))
        assert "datasheet" in text and "mesh-scale ranking" in text

    def test_render_empty_mentions_mesh_shapes(self, tmp_path):
        from repro_torch.tune.store import TuneStore
        text = NR.render_net_report([], machine="cpu-host",
                                    store=TuneStore(str(tmp_path / "t.json")))
        assert "mesh_shapes" in text


class TestMeshShapesAxis:
    def test_alias_maps_to_meshes(self):
        from repro_torch.sweep.spec import normalize_axes
        assert normalize_axes({"mesh_shapes": ["1x8", (2, 4)]}) == \
            {"meshes": ((1, 8), (2, 4))}

    def test_both_spellings_rejected(self):
        from repro_torch.sweep.spec import normalize_axes
        with pytest.raises(ValueError):
            normalize_axes({"mesh_shapes": ["1x8"], "meshes": [(1, 1)]})

    def test_from_dict_accepts_alias(self):
        from repro_torch.sweep.spec import SweepSpec
        spec = SweepSpec.from_dict({"name": "n", "configs": ["a"],
                                    "mesh_shapes": ["1x1", "1x8"]})
        assert spec.meshes == ((1, 1), (1, 8))


class TestNetworkBoundRule:
    """The reference's ``TestNetworkBoundRule`` over the port, and the
    port's finding against the reference's on the same records."""

    def test_fires_with_ceiling_provenance(self):
        from repro_torch.obs.advisor import rule_network_bound
        rec = _rec("a", {"data": 1, "model": 8}, 1e-3, 2e-3, 5e-3)
        rec.meta["net_ceilings"] = {
            "ici": {"bytes_per_s": 4e9, "n_devices": 8,
                    "git_sha": "deadbeef", "key": "net_ici|..."}}
        (f,) = rule_network_bound([rec])
        assert f.rule == "network_bound" and 0.5 < f.severity <= 1.0
        assert any("measured over 8" in e for e in f.evidence)
        assert "python -m repro_torch net report" in f.remediation

    def test_datasheet_note_without_ceilings(self):
        from repro_torch.obs.advisor import rule_network_bound
        (f,) = rule_network_bound(
            [_rec("a", {"data": 1, "model": 8}, 1e-3, 2e-3, 5e-3)])
        assert any("datasheet" in e and
                   "python -m repro_torch net characterize" in e
                   for e in f.evidence)

    def test_silent_when_memory_bound(self):
        from repro_torch.obs.advisor import rule_network_bound
        assert rule_network_bound([_rec("a", {}, 1e-3, 5e-3, 1e-3)]) == []

    def test_each_mesh_shape_is_its_own_finding(self):
        from repro_torch.obs.advisor import rule_network_bound
        found = rule_network_bound([
            _rec("a", {"data": 1, "model": 4}, 1e-3, 2e-3, 5e-3,
                 run_id="r1", ts=1.0),
            _rec("a", {"data": 1, "model": 8}, 1e-3, 2e-3, 9e-3,
                 run_id="r2", ts=2.0)])
        assert {f.subject for f in found} == {"a@1x4", "a@1x8"}

    def test_evidence_equals_reference(self, sweep_jsonl):
        from repro.obs.advisor import rule_network_bound as r_rule
        from repro_torch.obs.advisor import rule_network_bound as p_rule
        p, r = _both(sweep_jsonl)
        nc = {"ici": {"bytes_per_s": 4e9, "n_devices": 8, "git_sha": "d",
                      "key": "k"}}
        for x in (p[0], r[0]):
            x.meta["net_ceilings"] = nc
        pf, rf = p_rule(p), r_rule(r)
        assert [(f.subject, f.severity, f.evidence) for f in pf] == \
            [(f.subject, f.severity, [e.replace("repro ", "repro_torch ")
                                      for e in f.evidence]) for f in rf]


# --------------------------------------------------------------------------
# the ranks themselves
# --------------------------------------------------------------------------

def test_reference_dcn_leg_moves_more_than_its_rows_count():
    """Found in the reference (``src/repro/net/collectives.py:82-84,
    141, 152``): its dcn leg shards an ``(n·elems,)`` array over the
    ``"pod"`` axis of a ``(2, n/2)`` mesh only, so each device holds
    ``n/2 · elems`` elements while the row's payload counts ``elems``:
    its dcn ceiling reads ``n/2`` times high.  The port's rank holds
    ``elems`` on both legs, as its rows say."""
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    n, elems = 8, 1024
    dcn = NamedSharding(AbstractMesh((2, n // 2), ("pod", "x")), P("pod"))
    ici = NamedSharding(AbstractMesh((n,), ("x",)), P("x"))
    assert ici.shard_shape((n * elems,)) == (elems,)
    assert dcn.shard_shape((n * elems,)) == (n // 2 * elems,)
    assert R_NC.payload_bytes("all_reduce", elems, 2) == elems * 4


def test_a_failing_rank_fails_the_launch_with_its_log():
    """A rank that raises ends the launch with its exit code and the tail
    of its log, and no rank outlives it."""
    from repro_torch.distributed.ranks import launch
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[\d.*exited") as e:
        launch("repro_torch.net.characterize:rank_job", {}, 2,
               timeout_s=120)
    assert "KeyError: 'sizes'" in str(e.value)


# --------------------------------------------------------------------------
# the ceilings in the records: Session.record and the sweep engine
# --------------------------------------------------------------------------

def test_record_and_sweep_points_stamp_and_use_the_ceilings(tmp_path):
    """With ceilings stored under ``cpu-host``: ``Session.record`` stamps
    the store's view (the reference's ``net_ceilings`` of the same
    file); an analytical mesh point stamps it too, and its collective
    bounds divide by the measured bandwidths plus the measured latency
    a collective; its analysis cache misses once the ceilings change."""
    from repro.tune.store import TuneStore as RStore
    from repro_torch.session.session import Session
    from repro_torch.sweep import engine as E
    from repro_torch.sweep.spec import SweepSpec
    from repro_torch.trace.store import TraceStore

    s = Session(machine="cpu-host", device="cpu",
                workspace=str(tmp_path / "ws"))
    store = s.workspace.tune_store
    spec = SweepSpec(name="n", configs=("glm4-9b",), seqs=(16,),
                     batches=(2,), meshes=((1, 2),), measure=False,
                     smoke=True, machine="cpu-host")
    (point,), _ = spec.expand()
    before = E._cache_path("c", point, store.path)
    C._persist(C._fit_rows(_synthetic_rows()), "cpu-host", 8, (1024,),
               store)
    assert E._cache_path("c", point, store.path) != before
    want = R_C.net_ceilings("cpu-host", RStore(store.path))

    rec = s.record("glm4-9b", seq=16, batch=2, iters=1, warmup=0).data
    assert rec.meta["net_ceilings"] == want

    res = s.sweep(spec, workers=0)
    assert res.exit_code == 0, res.text
    (mesh_rec,) = TraceStore(s.workspace.sweep_path).records()
    assert mesh_rec.meta["net_ceilings"] == want
    ici = want["ici"]
    bwd = mesh_rec.phases["bwd"]
    assert bwd["ici_bytes"] > 0 and bwd["dcn_bytes"] == 0
    # bytes over the measured bandwidth, plus its latency per collective
    n_coll = (bwd["ici_bound_s"] - bwd["ici_bytes"] / ici["bytes_per_s"]) \
        / ici["latency_s"]
    assert n_coll >= 1 and n_coll == pytest.approx(round(n_coll), abs=1e-6)
