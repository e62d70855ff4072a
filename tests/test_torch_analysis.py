"""The port's aten-op analysis against the reference's HLO analysis, on the
fwd phase of glm4-9b smoke at seq=32, batch=4.

* matmul-category FLOPs must be equal **exactly** (37,748,736: wq, wk,
  wv, wo, QKᵀ, PV and the 3 MLP products over 2 layers, plus the
  unembed);
* under O1 those FLOPs are in ceiling class ``bf16``;
* total FLOPs within 5% (elementwise conventions differ: an aten op and
  an HLO op do not always count the same sub-operations);
* HBM bytes are printed, not asserted: an aten op is one kernel with all
  of its operands in device memory, an XLA fusion keeps intermediates on
  chip, so the byte totals differ by fusion granularity.
"""

import math

import pytest
import torch

from repro.session import Session as RSession
from repro.trace import store as r_store
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.core.machine import CPU_HOST, H100_SXM
from repro_torch.core.op_analysis import analyze_fn, dtype_class, dtype_name
from repro_torch.models.transformer import matmul_flops
from repro_torch.session.result import RooflineResult
from repro_torch.session.session import Session
from repro_torch.trace import store as p_store
from repro_torch.trace.collector import attribute_time

SMOKE_MATMUL_FLOPS = 37_748_736
REF_TOTAL_FLOPS = 38_919_067


def _matmul(analysis) -> float:
    return sum(k.total_flops for k in analysis.kernels
               if k.category == "matmul")


@pytest.fixture(scope="module")
def analyses(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    ref = RSession(machine="cpu-host", workspace=ws)
    port = Session(machine="cpu-host", device="cpu")
    out = {}
    for amp in ("O0", "O1"):
        r = ref.profile("glm4-9b", phases=("fwd",), seq=32, batch=4, amp=amp)
        p = port.profile("glm4-9b", phases=("fwd",), seq=32, batch=4, amp=amp)
        out[amp] = (r.analyses["fwd"], p.analyses["fwd"])
    return out


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_matmul_flops_equal_reference_exactly(analyses, amp):
    r, p = analyses[amp]
    assert _matmul(r) == SMOKE_MATMUL_FLOPS
    assert _matmul(p) == SMOKE_MATMUL_FLOPS
    assert matmul_flops(get_smoke("glm4-9b"), 4, 32) == SMOKE_MATMUL_FLOPS


def test_o1_matmul_flops_are_bf16(analyses):
    _, p = analyses["O1"]
    for k in p.kernels:
        if k.category == "matmul":
            assert set(k.flops_by_class) == {"bf16"}, k
    assert p.total_flops_by_class["bf16"] >= SMOKE_MATMUL_FLOPS
    _, p0 = analyses["O0"]
    assert set(p0.total_flops_by_class) == {"f32"}


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_total_flops_within_five_percent(analyses, amp):
    r, p = analyses[amp]
    assert r.total_flops == REF_TOTAL_FLOPS
    assert abs(p.total_flops - r.total_flops) <= 0.05 * r.total_flops
    print(f"{amp}: HBM bytes reference {r.total_hbm_bytes:.0f} "
          f"port {p.total_hbm_bytes:.0f}; kernels {len(r.kernels)} / "
          f"{len(p.kernels)}")


def test_census_has_reference_keys(analyses):
    r, p = analyses["O1"]
    assert p.zero_ai_census().keys() == r.zero_ai_census().keys()
    z_inv, z_bytes = p.zero_ai_census()["zero-AI"]
    assert z_inv > 0 and z_bytes > 0


def test_records_merge_across_layers(analyses):
    _, p = analyses["O0"]
    counts = sorted(k.exec_count for k in p.kernels
                    if k.category == "matmul")
    # per layer: wq/wo-shaped, wk=wv, QKᵀ, PV, gate=up, down → merged
    assert sum(counts) == 2 * 9 + 1
    assert all(k.vmem_bytes == k.hbm_bytes for k in p.kernels)
    assert {k.category for k in p.kernels} <= {"matmul", "elementwise",
                                               "reduction", "zero-ai"}


def test_full_width_analysis_allocates_nothing_and_counts_exactly():
    cfg = get_config("glm4-9b")
    res = Session(device="cpu").profile("glm4-9b", smoke=False, seq=2048,
                                        batch=2)
    a = res.analyses["fwd"]
    assert _matmul(a) == matmul_flops(cfg, 2, 2048) == 77_412_490_543_104
    # the 40-layer stack folds into a short table
    assert len(a.kernels) < 100
    assert max(k.exec_count for k in a.kernels) >= 40


def test_view_ops_are_free_and_copies_are_zero_ai():
    def fn(x, w):
        y = x.transpose(0, 1).reshape(4, 8)      # copy: non-contiguous
        return (y @ w).to(torch.bfloat16)

    a = analyze_fn(fn, (torch.zeros(4, 8), torch.zeros(8, 3)))
    ops = {k.opcode: k for k in a.kernels}
    assert "transpose" not in ops and "view" not in ops
    assert ops["mm"].flops_by_class == {"f32": 2 * 4 * 8 * 3}
    assert ops["clone"].is_zero_ai and ops["clone"].category == "zero-ai"
    assert ops["_to_copy"].hbm_bytes == 4 * 3 * 4 + 4 * 3 * 2


def test_dtype_classes():
    assert dtype_class(dtype_name(torch.bfloat16)) == "bf16"
    assert dtype_class(dtype_name(torch.float16)) == "bf16"
    assert dtype_class(dtype_name(torch.float32)) == "f32"
    assert dtype_class(dtype_name(torch.int8)) == "int8"
    assert dtype_class(dtype_name(torch.float8_e4m3fn)) == "int8"


def test_measured_profile_renders_on_host():
    res = Session(device="cpu").profile("glm4-9b", phases=("fwd",),
                                        measure=True, iters=2, warmup=1)
    assert isinstance(res, RooflineResult) and res.measured
    text = res.render(charts=1)
    assert "-- fwd --" in text and "bmm" in text          # kernel_table
    assert "markers: h/H=HBM v/V=VMEM" in text            # ascii_roofline
    assert math.isfinite(float(res.data["fwd"].output))
    payload = res.phases["fwd"]
    assert set(p_store.PHASE_METRICS) == set(r_store.PHASE_METRICS)
    assert set(p_store.PHASE_METRICS) <= set(payload)
    assert payload["launches"] == sum(
        k.exec_count for k in res.analyses["fwd"].kernels)
    assert [lv.level for lv in res.levels("fwd")] == ["vmem", "hbm"]


def test_attributed_time_sums_to_wall():
    res = Session(device="cpu").profile("glm4-9b")
    ks = attribute_time(res.analyses["fwd"], H100_SXM, 0.25)
    assert abs(sum(k.attributed_s for k in ks) - 0.25) < 1e-12
    assert ks == sorted(ks, key=lambda k: -k.attributed_s)


def test_profile_of_a_user_function():
    def mlp(x, w1, w2):
        return torch.relu(x @ w1) @ w2

    args = (torch.zeros(16, 32), torch.zeros(32, 64), torch.zeros(64, 8))
    res = Session(machine=CPU_HOST, device="cpu").profile(mlp, args)
    a = res.analyses["mlp"]
    assert _matmul(a) == 2 * 16 * 32 * 64 + 2 * 16 * 64 * 8
    assert "terms" not in res.render() and "mlp" in res.render()


@pytest.mark.parametrize("phase", ["bwd", "opt"])
def test_train_phases_wait_for_their_slice(phase, tmp_path):
    """The train phases have landed: bwd and opt match the reference's
    matmul FLOPs exactly (3x the fwd's, and none)."""
    ref = RSession(machine="cpu-host", workspace=str(tmp_path))
    r = ref.profile("glm4-9b", phases=(phase,), seq=32, batch=4, amp="O1")
    p = Session(machine="cpu-host", device="cpu").profile(
        "glm4-9b", phases=(phase,), seq=32, batch=4, amp="O1")
    want = {"bwd": 3 * SMOKE_MATMUL_FLOPS, "opt": 0}[phase]
    assert _matmul(r.analyses[phase]) == _matmul(p.analyses[phase]) == want
