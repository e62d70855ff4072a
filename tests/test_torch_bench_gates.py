"""The port's gate suites on the host: ``kernel_bench``, ``fused_bench``,
``dispatch_bench`` and ``serve_bench`` (``repro_torch.bench``).

* Each runs with ``device="cpu"`` and emits the reference's row names
  (``benchmarks/*.py``); ``REF_ROWS`` marks each name that is a TPU
  figure there.
* kernel_bench's kernel bytes equal the reference's ``FA.hbm_bytes`` and
  ``SSD.hbm_bytes`` exactly at the suite's shapes; its plain-chain bytes
  come from the port's op walk and exceed them.
* fused_bench's gate row is ``zero_ai_census.lm_step_summary`` of the
  census, and the suite is ``ok`` if and only if the fused step launches
  strictly fewer kernels and cuts zero-AI launches by at least the gate
  (0.30, the reference's constant); while it does not, the suite fails
  with the gate's message and nothing else, and carries no rows.
* dispatch_bench's table gate holds on a measured table, and its step
  gate raises on walls given to it (the host's walls are not held: the
  tests share the host's cores).
* serve_bench completes the same requests in the same ticks as the
  reference's ``repro.session.Session.serve`` on the same arguments.
"""

import ast
import os

import pytest
import torch

from repro.kernels.flash_attention import kernel as r_fa
from repro.kernels.ssd_scan import kernel as r_ssd
from repro_torch.bench import __main__ as bench_main
from repro_torch.bench import (dispatch_bench, fused_bench, kernel_bench,
                               serve_bench, zero_ai_census)
from repro_torch.tune.dispatch import DispatchRecord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's row names per suite (``benchmarks/*.py``)
REF_ROWS = {
    "kernel_bench": [
        "attn_xla_hbm_bytes",            # the plain chain's walked bytes
        "attn_flash_hbm_bytes", "attn_traffic_ratio",
        "attn_mem_term_xla_ms", "attn_mem_term_flash_ms",
        "ssd_xla_hbm_bytes", "ssd_kernel_hbm_bytes", "ssd_traffic_ratio",
        "flash_interpret_256_us"],       # TPU: the Pallas interpreter's
                                         # fp32 wall; here the kernel's
    "fused_bench": [
        "norm_residual", "swiglu", "adamw", "census_gate",
        "trace_fwd_reference", "trace_bwd_reference", "trace_opt_reference",
        "trace_fwd_fused", "trace_bwd_fused", "trace_opt_fused",
        "trace_fwd_measured", "trace_bwd_measured", "trace_opt_measured",
        "trace_step", "trace_step_measured"],
    "dispatch_bench": [
        "step_off", "step_static", "step_measured", "table_gate"],
    "serve_bench": [
        "minitron-4b_tok_s", "minitron-4b_ttft", "minitron-4b_tpot",
        "minitron-4b_prefill", "minitron-4b_decode"],
}


def _ref_constant(module: str, name: str):
    """A module-level constant of ``benchmarks/<module>.py``, read from its
    source (the reference's benchmarks are not a package on the path)."""
    path = os.path.join(ROOT, "benchmarks", f"{module}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(f"{name} not in {path}")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the
    host's cores (as ``test_torch_bench.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four suites on the host in a fresh workspace (dispatch_bench's
    step gate recorded instead of raised: the host's walls), and
    fused_bench's three sections called one by one: (results, the
    sections' rows, the census gate's error or None, the step gate's
    walls)."""
    ws = str(tmp_path_factory.mktemp("ws"))
    walls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_WORKSPACE", ws)
        mp.setattr(dispatch_bench, "step_gate", walls.append)
        res = bench_main.run(tuple(REF_ROWS), "cpu")
        census_error = None
        try:
            gate = fused_bench.census_gate_rows(device="cpu")
        except AssertionError as e:
            census_error = e
            # the row the gate raised on closes its message
            msg = str(e)
            gate = [("fused_bench/census_gate", 0.0,
                     msg[msg.rindex("(") + 1:-1])]
        sections = (fused_bench.micro_rows("cpu") + gate
                    + fused_bench.trace_rows(device="cpu"))
    return res, sections, census_error, walls


@pytest.mark.parametrize("suite", list(REF_ROWS))
def test_suite_emits_the_reference_rows(runs, suite):
    res, sections, _, _ = runs
    rows = sections if suite == "fused_bench" else res[suite]["rows"]
    if suite != "fused_bench":
        assert res[suite]["ok"]
    assert [n for n, _, _ in rows] == [f"{suite}/{n}"
                                       for n in REF_ROWS[suite]]


def test_kernel_bench_bytes_equal_the_references():
    walked, fa = kernel_bench.attention_bytes()
    B, H, S, hd = kernel_bench.ATTN
    assert fa == r_fa.hbm_bytes(B * H, S, S, hd) == 33_554_432
    assert walked > fa
    walked, ssd = kernel_bench.ssd_bytes()
    Bs, Ss, Hs, P, N = kernel_bench.SSD
    assert ssd == r_ssd.hbm_bytes(Bs, Hs, Ss, P, N) == 19_005_440
    assert walked > ssd


def test_kernel_bench_rows_carry_the_bytes_and_the_dtype(runs):
    rows = {n: d for n, _, d in runs[0]["kernel_bench"]["rows"]}
    assert rows["kernel_bench/attn_flash_hbm_bytes"] == "0.0336GB"
    assert rows["kernel_bench/ssd_kernel_hbm_bytes"] == "0.0190GB"
    assert float(rows["kernel_bench/attn_traffic_ratio"][:-1]) > 1
    assert rows["kernel_bench/flash_interpret_256_us"] == \
        "dtype=bfloat16;plain"


def test_fused_gate_is_the_census_summary_and_decides_ok(runs):
    res, sections, census_error, _ = runs
    assert fused_bench.ZERO_AI_GATE == 0.30 == \
        _ref_constant("fused_bench", "ZERO_AI_GATE")
    assert fused_bench.TRACE_SEQ == _ref_constant("fused_bench", "TRACE_SEQ")
    s = zero_ai_census.lm_step_summary(
        zero_ai_census.lm_phase_census(device="cpu"))
    gate = next(d for n, _, d in sections if n == "fused_bench/census_gate")
    assert gate == (f"launches={s['launches_ref']}vs{s['launches_fused']};"
                    f"zero={s['zero_ref']}vs{s['zero_fused']};"
                    f"zero_reduction={s['zero_reduction']:.2f}")
    passes = (s["launches_fused"] < s["launches_ref"]
              and s["zero_reduction"] >= fused_bench.ZERO_AI_GATE)
    assert res["fused_bench"]["ok"] is passes
    assert (census_error is None) is passes
    if not passes:
        # the zero-AI gate's message and nothing else; main raises before
        # the trace, so the suite carries no rows, as the reference's
        assert str(census_error) == (
            f"fused zero-AI reduction {s['zero_reduction']:.2f} below the "
            f"{fused_bench.ZERO_AI_GATE} gate ({gate})")
        assert res["fused_bench"]["error"] == \
            f"AssertionError: {census_error}"
        assert res["fused_bench"]["rows"] == []


def test_fused_trace_rows_name_the_onchip_level(runs):
    _, sections, _, _ = runs
    for name, us, derived in sections:
        if name.startswith("fused_bench/trace_") and "step" not in name:
            keys = [kv.split("=")[0] for kv in derived.split(";")]
            assert keys == ["hbm_frac", "l2_frac", "roof"] and us > 0


def test_fused_micro_cases_compute_their_plain_chains():
    """On the host each wrapper runs its plain version: it must compute
    what the micro row's chain computes, at fp32 tolerance."""
    for c in fused_bench.micro_cases("cpu", rows_n=64, d=128):
        got, want = c.fused(*c.args), c.plain(*c.args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert c.nbytes > 0 and c.nflops > 0


def test_dispatch_gates(runs):
    res, _, _, walls = runs
    assert dispatch_bench.STEP_TOLERANCE == 1.10 == \
        _ref_constant("dispatch_bench", "STEP_TOLERANCE")
    # the measured run: the table gate held, the step gate was asked once
    rows = {n: d for n, _, d in res["dispatch_bench"]["rows"]}
    table = dict(kv.split("=") for kv in
                 rows["dispatch_bench/table_gate"].split(";"))
    assert int(table["winners"]) > 0 and table["violations"] == "0"
    assert len(walls) == 1 and set(walls[0]) == {"off", "static", "auto"}
    # the step gate on given walls
    dispatch_bench.step_gate({"off": 3.0, "static": 1.0, "auto": 1.1})
    with pytest.raises(AssertionError, match="routing is picking losers"):
        dispatch_bench.step_gate({"off": 3.0, "static": 1.0, "auto": 1.11})

    def rec(impl, fused, ref):
        return DispatchRecord(
            schema_version=1, key=f"k{impl}{fused}", op="fused_norm",
            shapes=[[8, 8]], dtypes=["float32"], flags={},
            machine="cpu-host", impl=impl, fused_wall_s=fused,
            ref_wall_s=ref, iters=3, timestamp=0.0, git_sha="",
            torch_version="", host={})
    assert dispatch_bench.table_violations(
        [rec("fused", 1.0, 2.0), rec("reference", 2.0, 1.0)]) == []
    assert len(dispatch_bench.table_violations(
        [rec("fused", 2.0, 1.0), rec("reference", 1.0, 2.0)])) == 2


def test_serve_bench_matches_the_reference_session(runs, tmp_path):
    from repro.session import Session, Workspace
    rows = {n: d for n, _, d in runs[0]["serve_bench"]["rows"]}
    got = dict(kv.split("=") for kv in
               rows["serve_bench/minitron-4b_tok_s"].split(";"))
    ref = Session(machine="cpu-host",
                  workspace=Workspace(str(tmp_path / "ws"))).serve(
        serve_bench.CONFIG, **serve_bench.SERVE_ARGS)
    summ = ref.data[1].summary()
    assert got["completed"] == f"{summ['completed']}/{summ['requests']}"
    assert int(got["ticks"]) == summ["ticks"]
    assert summ["completed"] == serve_bench.N_REQUESTS
