"""The port's tune store, Hopper candidate spaces and search
(``repro_torch.tune``) — with deterministic fake timers, as
``tests/test_tune.py`` holds the reference's: nothing here times a
kernel, and the ``cuda`` spaces are listed (their operands are built only
when a candidate is timed on the card)."""

import json

import pytest
import torch

from repro.tune import store as r_store
from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.ert import ops
from repro_torch.tune import space as sp
from repro_torch.tune import store as ts
from repro_torch.tune.search import search, search_all, tune_ceilings
from repro_torch.tune.store import (TuneStore, best_config, config_source,
                                    make_record, tune_key)


def fake_timer(walls=None, default=1.0):
    """Wall per params tuple (``default`` otherwise); records each call."""
    calls = []

    def timer(cand, iters, warmup):
        calls.append(cand.dict)
        return (walls or {}).get(tuple(sorted(cand.dict.items())), default)

    timer.calls = calls
    return timer


def _rec(kernel="fused_norm", shape=(256, 64), params=None,
         machine="h100-sxm", backend="cuda", metric=3e9):
    return make_record(kernel, shape, "float32", machine, backend,
                       params or {"threads": 512, "blocks_per_sm": 8},
                       wall_s=1e-4, metric=metric, metric_name="bytes_per_s",
                       default_wall_s=2e-4, default_metric=metric / 2,
                       n_candidates=4)


def test_search_persists_then_all_store_hits(tmp_path):
    path = str(tmp_path / "tune.json")
    timer = fake_timer()
    first = search_all(backend="cuda", smoke=True, machine="h100-sxm",
                       store=path, timer=timer)
    assert [o.record.kernel for o in first] == list(sp.CUDA_KERNELS)
    assert not any(o.cached for o in first)
    n_timed = len(timer.calls)
    assert n_timed == sum(len(o.candidates) for o in first) > 8
    second = search_all(backend="cuda", smoke=True, machine="h100-sxm",
                        store=TuneStore(path), timer=timer)
    assert all(o.cached and not o.candidates for o in second)
    assert len(timer.calls) == n_timed            # not one more timing
    assert [o.record.to_dict() for o in second] == \
        [o.record.to_dict() for o in first]


def test_winner_and_force_re_times(tmp_path):
    path = str(tmp_path / "tune.json")
    fast = (("blocks_per_sm", 8), ("threads", 128))
    rec = search("fused_swiglu", (256, 128), backend="cuda", store=path,
                 smoke=True, machine="h100-sxm",
                 timer=fake_timer({fast: 0.5})).record
    assert rec.params == {"threads": 128, "blocks_per_sm": 8}
    assert rec.speedup == pytest.approx(2.0)
    assert rec.default_wall_s == 1.0 and rec.wall_s == 0.5
    timer = fake_timer({(("blocks_per_sm", 16), ("threads", 256)): 0.25})
    hit = search("fused_swiglu", (256, 128), backend="cuda", store=path,
                 smoke=True, machine="h100-sxm", timer=timer)
    assert hit.cached and not timer.calls
    forced = search("fused_swiglu", (256, 128), backend="cuda", store=path,
                    smoke=True, machine="h100-sxm", timer=timer, force=True)
    assert not forced.cached and timer.calls
    assert forced.record.params == {"threads": 256, "blocks_per_sm": 16}
    assert TuneStore(path).get(forced.record.key).params == \
        forced.record.params


@pytest.mark.parametrize("backend", sp.BACKENDS)
@pytest.mark.parametrize("smoke", [True, False])
def test_every_space_contains_the_default(backend, smoke):
    for kernel in sp.kernels_for(backend):
        shape = sp.default_shape(kernel, smoke)
        cands = sp.candidates(kernel, shape, "float32", backend, smoke)
        defaults = [c for c in cands
                    if sp.is_default(kernel, backend, shape, c.dict)]
        assert len(defaults) == 1, kernel
        if backend == "cuda":
            # the kernels' own defaults (kernels/config.py::DEFAULTS), and
            # the characterize rung of the FMA ladder
            want = {**kc.DEFAULTS[kernel].dict,
                    **(sp.CUDA_FMA_DEFAULT if kernel == "fma_chain"
                       else {})}
            if kernel == "ssd_scan":
                want["chunk"] = sp.fit_block(want["chunk"], shape[2])
            assert defaults[0].dict == want
        assert len({c.params for c in cands}) == len(cands)


def test_compile_time_tiles_hold_the_compiled_config_alone():
    # the wgmma GEMM's tile: two consumer warpgroups of 64 x 256, K step 64
    assert kc.DEFAULTS["ert_gemm"].dict == {"block_m": 128, "block_n": 256,
                                            "block_k": 64}
    for kernel in ("ert_gemm", "flash_attention"):
        shape = sp.default_shape(kernel)
        (cand,) = sp.candidates(kernel, shape, "bfloat16", "cuda")
        assert cand.dict == kc.DEFAULTS[kernel].dict
    chunks = {c.dict["chunk"] for c in sp.candidates(
        "ssd_scan", sp.default_shape("ssd_scan"), "float32", "cuda")}
    assert chunks == {64, 128, 256}
    with pytest.raises(KeyError, match="no search space"):
        sp.candidates("fused_norm", (8, 8), backend="torch")


#: the tile ert_gemm was compiled for before its wgmma kernel
OLD_GEMM_TILE = {"block_m": 128, "block_n": 128, "block_k": 32}
#: the digest of a build that is not this one
OTHER_BUILD = "0123456789abcdef"


def _stale_winner_is_a_miss(tmp_path, params, library):
    """A workspace tuned against another build of ert.cu: the launch
    lookup takes the default and the search times again."""
    path = str(tmp_path / "tune.json")
    shape, default = (8192, 8192, 8192), kc.DEFAULTS["ert_gemm"]
    stale = make_record("ert_gemm", shape, "bfloat16", "h100-sxm", "cuda",
                        params or default.dict, wall_s=5.7e-3, metric=1.9e14,
                        metric_name="flops_per_s", default_wall_s=5.7e-3,
                        default_metric=1.9e14, n_candidates=1)
    raw = stale.to_dict()
    if library is None:
        del raw["library"]
    else:
        raw["library"] = library
    TuneStore(path).put_many({stale.key: raw})
    assert config_source("ert_gemm", shape, "bfloat16", "h100-sxm",
                         store=path) == ("default", default)
    assert best_config("ert_gemm", shape, "bfloat16", "h100-sxm",
                       store=path) == default
    a = torch.empty(shape[:2], dtype=torch.bfloat16, device="meta")
    with ts.bind(store=path, machine="h100-sxm"):
        assert kc.for_launch("ert_gemm", None, a, shape) == default
    timer = fake_timer()
    out = search("ert_gemm", shape, "bfloat16", machine="h100-sxm",
                 store=path, timer=timer)
    assert not out.cached and timer.calls == [default.dict]
    fresh = TuneStore(path).get(stale.key)
    assert fresh.params == default.dict
    assert fresh.library == build.digest("ert") != library
    again = search("ert_gemm", shape, "bfloat16", machine="h100-sxm",
                   store=path, timer=timer)
    assert again.cached and len(timer.calls) == 1
    assert config_source("ert_gemm", shape, "bfloat16", "h100-sxm",
                         store=path)[0] == "tuned"


def test_stale_compiled_tile_winner_is_a_miss(tmp_path):
    # the 128 x 128 x 32 winner of the wmma kernel's build
    _stale_winner_is_a_miss(tmp_path, OLD_GEMM_TILE, OTHER_BUILD)


@pytest.mark.parametrize("params,library", [
    (None, OTHER_BUILD),               # this tile, another kernel body
    (OLD_GEMM_TILE, None),             # a store written before the stamp
], ids=["same-tile-other-build", "unstamped"])
def test_stale_build_winner_is_a_miss(tmp_path, params, library):
    _stale_winner_is_a_miss(tmp_path, params, library)


def test_records_carry_their_kernels_library_digest(tmp_path, monkeypatch):
    for kernel in sp.CUDA_KERNELS:
        rec = _rec(kernel, params={})
        assert rec.library == build.digest(build.LIBRARY_OF[kernel])
        assert ts.current(rec.to_dict())
    host = _rec("ert_gemm", params={}, backend="torch")
    assert host.library == "" and ts.current(host.to_dict())
    assert not ts.current({**host.to_dict(), "library": OTHER_BUILD})
    # the digest follows the source and the flags
    before = build.digest("ert")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for header in build.CSRC.glob("*.cuh"):
        (csrc / header.name).write_bytes(header.read_bytes())
    (csrc / "ert.cu").write_bytes(
        (build.CSRC / "ert.cu").read_bytes() + b"// edited\n")
    monkeypatch.setattr(build, "_DIGESTS", {})
    assert build.digest("ert") == before
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "_DIGESTS", {})
    edited = build.digest("ert")
    assert edited != before
    assert build.library_path("ert").name == f"libert_{edited}.so"
    monkeypatch.setenv("REPRO_NVCC_FLAGS", "-DERT_GEMM_WATCHDOG")
    monkeypatch.setattr(build, "_DIGESTS", {})
    assert build.digest("ert") not in (before, edited)
    assert build.nvcc_flags()[-1] == "-DERT_GEMM_WATCHDOG"


def test_multi_pass_triad_space_holds_resident_grids_only():
    # reps passes of a grid that runs in waves would re-read a late
    # wave's slice from L2 and read above the HBM roof; the bulk-copy
    # kernel's 96 KiB ring lets an SM hold two blocks, and it refuses a
    # larger grid, so no candidate asks for one, with reps or without
    multi = sp.candidates("triad", (1 << 26, 8), "float32", "cuda")
    single = sp.candidates("triad", (1 << 26,), "float32", "cuda")
    for cands in (multi, single):
        assert all(c.dict["threads"] * c.dict["blocks_per_sm"]
                   <= sp.THREADS_PER_SM for c in cands)
        assert {c.dict["blocks_per_sm"] for c in cands} == \
            set(sp.TRIAD_BLOCKS_PER_SM) == {1, 2}
        assert len(cands) == len(sp.THREADS) * len(sp.TRIAD_BLOCKS_PER_SM)
    assert kc.DEFAULTS["triad"].get("blocks_per_sm") == 2


def test_best_config_falls_back_to_defaults_on_a_miss(tmp_path):
    path = str(tmp_path / "tune.json")
    for kernel in sp.CUDA_KERNELS:
        assert best_config(kernel, (8, 8), "float32", "h100-sxm",
                           store=path) == kc.DEFAULTS[kernel]
        assert kc.best_config(kernel, (8, 8), store=path) == \
            kc.DEFAULTS[kernel]
    TuneStore(path).put(_rec())
    src, cfg = config_source("fused_norm", (256, 64), "float32", "h100-sxm",
                             store=path)
    assert src == "tuned"
    assert cfg == kc.DEFAULTS["fused_norm"].replace(threads=512,
                                                    blocks_per_sm=8)
    assert kc.best_config("fused_norm", (256, 64), "float32", "h100-sxm",
                          store=path) == cfg
    # another shape, dtype, machine or backend is a miss
    for args in (((256, 65), "float32", "h100-sxm", "cuda"),
                 ((256, 64), "bfloat16", "h100-sxm", "cuda"),
                 ((256, 64), "float32", "cpu-host", "cuda"),
                 ((256, 64), "float32", "h100-sxm", "torch")):
        assert config_source("fused_norm", *args, store=path)[0] == \
            "default"


def test_an_explicit_config_wins_over_the_store(tmp_path):
    cfg = kc.DEFAULTS["triad"].replace(threads=64)
    x = torch.empty(4)
    assert kc.for_launch("triad", cfg, x, (4,)) == cfg
    from repro_torch.tune.dispatch import dispatch_scope
    path = str(tmp_path / "tune.json")
    TuneStore(path).put(_rec("triad", (4,), {"threads": 1024,
                                             "blocks_per_sm": 4},
                             machine="cpu-host"))
    with dispatch_scope(store=path):
        assert kc.for_launch("triad", None, x, (4,)).get("threads") == 1024
        assert kc.for_launch("triad", cfg, x, (4,)) == cfg
    with dispatch_scope(store=str(tmp_path / "empty.json")):
        assert kc.for_launch("triad", None, x, (4,)) == kc.DEFAULTS["triad"]


def test_characterize_tuned_takes_the_store_winners(tmp_path):
    path = str(tmp_path / "tune.json")
    timer = fake_timer()
    searched = tune_ceilings(store=path, smoke=True, backend="torch",
                             timer=timer)
    n = len(timer.calls)
    spec = ops.characterize(device="cpu", tuned=True, smoke=True,
                            store=path)
    assert spec.empirical and spec.name == "cpu-host"
    assert spec.peak_flops["f32"] == searched["flops_f32"].record.metric
    assert spec.peak_flops["bf16"] == max(
        searched["flops_bf16"].record.metric,
        searched["gemm_bf16"].record.metric)
    assert spec.hbm.bytes_per_s == searched["bw_hbm"].record.metric
    assert spec.vmem.bytes_per_s == searched["bw_vmem"].record.metric
    assert len(timer.calls) == n                   # all store hits
    keys = set(TuneStore(path).keys())
    assert tune_key("triad", (1 << 14, 2), "float32", "cpu-host",
                    "torch") in keys


def test_the_reference_reads_a_port_store_and_back(tmp_path):
    from repro.tune import dispatch as r_dsp
    from repro_torch.tune import dispatch as dsp
    path = str(tmp_path / "tune.json")
    mine = TuneStore(path).put(_rec())
    key = dsp.make_key("fused_norm", [(8, 16), (16,)], ["float32"] * 2,
                       {"kind": "layernorm", "out": "float32"})
    with dsp.dispatch_scope(store=path, mode="measure", device="cpu",
                            timer=lambda impl, *a: {"fused": 1.0,
                                                    "reference": 2.0}[impl]):
        assert dsp.decide(key) == "fused"
    theirs = r_store.TuneStore(path)
    got = theirs.get(mine.key)
    assert got.params == mine.params and got.backend == "cuda"
    assert theirs.get_dispatch(key.key)["impl"] == "fused"
    assert r_dsp.best_impl(key.key, store=theirs) == "fused"
    # the reference writes; the port reads both namespaces back
    theirs.put(r_store.make_record(
        "triad", (1024,), "float32", "cpu-host", "pallas",
        {"block": 512, "double_buffer": False}, wall_s=1e-4, metric=1e9,
        metric_name="bytes_per_s", default_wall_s=2e-4, default_metric=5e8,
        n_candidates=2))
    back = TuneStore(path)
    assert {r.key for r in back.records()} == \
        {mine.key, r_store.tune_key("triad", (1024,), "float32",
                                    "cpu-host", "pallas")}
    assert back.get_dispatch(key.key)["impl"] == "fused"
    with open(path) as f:
        assert set(json.load(f)) == {"schema_version", "records", "dispatch"}


def test_corrupt_and_newer_schema_stores_warn_and_do_not_fail(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="corrupt"):
        assert TuneStore(str(path)).get("anything") is None
    with pytest.warns(UserWarning, match="corrupt"):
        assert best_config("triad", (4,), store=str(path)) == \
            kc.DEFAULTS["triad"]
    path.write_text(json.dumps({"schema_version": ts.SCHEMA_VERSION + 1,
                                "records": {"k": {"kernel": "triad"}}}))
    with pytest.warns(UserWarning, match="newer"):
        assert TuneStore(str(path)).records() == []
    path.write_text(json.dumps({
        "schema_version": ts.SCHEMA_VERSION,
        "records": {"k": {"schema_version": ts.SCHEMA_VERSION + 1},
                    "bad": [1, 2]}}))
    with pytest.warns(UserWarning, match="newer"):
        assert TuneStore(str(path)).get("k") is None
    assert TuneStore(str(path)).get("bad") is None
    # a write over a corrupt store starts it afresh
    path.write_text("{not json")
    st = TuneStore(str(path))
    with pytest.warns(UserWarning, match="corrupt"):
        st.put(_rec())
    assert len(TuneStore(str(path)).records()) == 1


def test_workspace_owns_the_default_store(tmp_path, monkeypatch):
    from repro_torch.session.workspace import Workspace
    monkeypatch.setenv("REPRO_WORKSPACE", str(tmp_path / "ws"))
    assert ts.default_store_path() == str(tmp_path / "ws" / "tune.json")
    ws = Workspace()
    assert ws.tune_path == ts.default_store_path()
    assert ws.tune_store is ts._as_store(ws.tune_path)
    assert "benchmarks" not in ts.default_store_path()


def test_active_kernel_configs_sources(tmp_path):
    path = str(tmp_path / "tune.json")
    out = ts.active_kernel_configs("h100-sxm", path)
    assert all(v["source"] == "default" for v in out.values())
    TuneStore(path).put(_rec())
    out = ts.active_kernel_configs("h100-sxm", path)
    assert out["fused_norm"]["source"] == "tuned_available"
    assert out["fused_norm"]["entries"] == [
        {"shape": [256, 64], "dtype": "float32",
         "params": {"threads": 512, "blocks_per_sm": 8}}]
    assert ts.active_kernel_configs("cpu-host", path)["fused_norm"][
        "source"] == "default"


def test_cli_search_show_apply_loop(tmp_path, capsys, monkeypatch):
    import importlib

    from repro_torch.cli import main
    search_mod = importlib.import_module("repro_torch.tune.search")
    store = str(tmp_path / "tune.json")
    assert main(["tune", "show", "--store", store]) == 2
    monkeypatch.setattr(search_mod, "_time_candidate", fake_timer())
    assert main(["tune", "search", "--device", "cpu", "--smoke",
                 "--store", store]) == 0
    out = capsys.readouterr().out
    assert "fma_chain/torch" in out and "[flops_bf16]" in out
    assert main(["tune", "search", "--device", "cpu", "--smoke",
                 "--store", store]) == 0
    assert "store hit" in capsys.readouterr().out
    assert main(["tune", "show", "--store", store]) == 0
    assert "fma_chain" in capsys.readouterr().out
    assert main(["tune", "search", "--device", "cpu", "--shape", "8",
                 "--store", store]) == 2
    assert main(["tune", "search", "--device", "cpu", "--kernel",
                 "fused_norm", "--store", store]) == 2
    assert main(["tune", "apply", "--device", "cpu", "--store", store]) == 0
    # a stored winner that now loses to the default is stale: exit 1
    rec = TuneStore(store).get(tune_key("fma_chain", (ops.SMOKE.chain_n,),
                                        "float32", "cpu-host", "torch"))
    monkeypatch.setattr(search_mod, "_time_candidate", fake_timer(
        {(("ilp", 4), ("n_iters", 64)): 2.0}, default=1.0))
    TuneStore(store).put(ts.TuneRecord.from_dict(
        {**rec.to_dict(), "params": {"n_iters": 64, "ilp": 4}}))
    assert main(["tune", "apply", "--device", "cpu", "--store", store]) == 1


def test_search_step_tunes_the_points_the_step_launches(tmp_path):
    """``search_step`` searches each (kernel, shape, dtype) the step
    launches at, a second call times nothing, and a wrapper's lookup at
    such a point finds the winner."""
    from repro_torch.tune import dispatch as dsp
    from repro_torch.tune.search import search_step
    path = str(tmp_path / "tune.json")
    fast = (("blocks_per_sm", 8), ("threads", 128))
    timer = fake_timer({fast: 0.5})
    first = search_step("glm4-9b", seq=16, batch=2, machine="h100-sxm",
                        store=path, smoke=True, device="cpu", timer=timer)
    points = dsp.step_points("glm4-9b", seq=16, batch=2, machine="h100-sxm",
                             store=path, device="cpu")
    assert [(o.record.kernel, tuple(o.record.shape), o.record.dtype)
            for o in first.values()] == points
    assert not any(o.cached for o in first.values())
    n = len(timer.calls)
    again = search_step("glm4-9b", seq=16, batch=2, machine="h100-sxm",
                        store=path, smoke=True, device="cpu", timer=timer)
    assert all(o.cached for o in again.values()) and len(timer.calls) == n
    only = search_step("glm4-9b", ["fused_swiglu"], seq=16, batch=2,
                       machine="h100-sxm", store=path, smoke=True,
                       device="cpu", timer=timer)
    assert [o.record.kernel for o in only.values()] == ["fused_swiglu"]
    kernel, shape, dtype = next(p for p in points if p[0] == "fused_norm")
    x = torch.empty(shape, dtype=sp.torch_dtype(dtype))
    with ts.bind(store=path, machine="h100-sxm"):
        assert kc.for_launch(kernel, None, x, shape).params == fast
    assert kc.for_launch(kernel, None, x, shape) == kc.DEFAULTS[kernel]


def test_session_tune_searches_no_guessed_shape(tmp_path):
    """On the host (``torch`` spaces) ``Session.tune`` runs the ceiling
    searches alone; the flash and SSD spaces only when named."""
    from repro_torch.session.session import Session
    s = Session(device="cpu", workspace=str(tmp_path / "ws"))
    res = s.tune(smoke=True)
    assert set(res.data) == {"flops_f32", "flops_bf16", "gemm_bf16",
                             "bw_hbm", "bw_vmem"}
    assert set(s.workspace.tune_store.keys()) == \
        {o.record.key for o in res.data.values()}
    with pytest.raises(KeyError, match="no torch search space"):
        s.tune(["fused_norm"], smoke=True)
