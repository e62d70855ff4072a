"""The port's machine model, roofline math and reports against the
reference's: identical records and identical machine specs (built here
from the reference's TPU / CPU constants, so the port holds none of them)
must give identical numbers and identical text."""

import dataclasses

import pytest

from repro.core import hlo_analysis as r_ha
from repro.core import machine as r_machine
from repro.core import report as r_report
from repro.core import roofline as r_roof
from repro_torch.core import machine as p_machine
from repro_torch.core import op_analysis as p_oa
from repro_torch.core import report as p_report
from repro_torch.core import roofline as p_roof


def port_spec(ref: r_machine.MachineSpec) -> p_machine.MachineSpec:
    return p_machine.MachineSpec(
        name=ref.name, peak_flops=dict(ref.peak_flops),
        mem_levels=tuple(p_machine.MemLevel(lv.name, lv.bytes_per_s,
                                            lv.capacity_bytes)
                         for lv in ref.mem_levels),
        ici_bytes_per_s=ref.ici_bytes_per_s, ici_links=ref.ici_links,
        dcn_bytes_per_s=ref.dcn_bytes_per_s, empirical=ref.empirical,
        net_levels=tuple(p_machine.NetLevel(lv.name, lv.bytes_per_s,
                                            lv.latency_s)
                         for lv in ref.net_levels))


# (name, opcode, exec_count, flops_by_class, hbm_bytes, vmem_bytes, category)
_RECORDS = [
    ("dot.1", "dot", 40, {"bf16": 2.0e12}, 3_000_000_000, 3_000_000_000,
     "matmul"),
    ("dot.2", "dot", 1, {"bf16": 5.0e9, "f32": 1.0e6}, 40_000_000,
     9_000_000, "matmul"),
    ("fusion.3", "fusion", 80, {"f32": 4.0e7}, 160_000_000, 20_000_000,
     "elementwise"),
    ("reduce.4", "reduce", 80, {"f32": 1.0e7}, 40_000_000, 40_000_000,
     "reduction"),
    ("copy.5", "copy", 120, {}, 64_000_000, 64_000_000, "zero-ai"),
    ("convert.6", "convert", 3, {}, 1_000_000, 0, "zero-ai"),
    ("exp.7", "exponential", 2, {"f32": 3.3e5}, 2_640_000, 2_640_000,
     "elementwise"),
]


def _records(mod):
    return [mod.KernelRecord(name=n, opcode=o, op_name=f"{o}/x",
                             exec_count=c, flops_by_class=dict(f),
                             hbm_bytes=h, vmem_bytes=v, category=cat)
            for n, o, c, f, h, v, cat in _RECORDS]


def _analysis(mod):
    return mod.ModuleAnalysis(_records(mod), [])


SPECS = [r_machine.TPU_V5E, r_machine.CPU_HOST,
         r_machine.TPU_V5E.with_empirical({"bf16": 150e12},
                                          {"hbm": 700e9, "vmem": 5e12})]


@pytest.fixture(params=SPECS, ids=["tpu-v5e", "cpu-host", "tpu-empirical"])
def specs(request):
    return request.param, port_spec(request.param)


def test_port_spec_mirrors_reference_fields(specs):
    ref, port = specs
    assert port.hbm.name == ref.hbm.name and port.vmem.name == ref.vmem.name
    assert port.interconnect == tuple(
        p_machine.NetLevel(lv.name, lv.bytes_per_s, lv.latency_s)
        for lv in ref.interconnect)
    for cls in ("bf16", "f32", "int8", "f8"):
        assert port.peak_for(cls) == ref.peak_for(cls)
        assert port.ridge_point(cls) == ref.ridge_point(cls)


def test_roofline_terms_identical(specs):
    ref, port = specs
    rt = r_roof.roofline_terms(_analysis(r_ha), ref)
    pt = p_roof.roofline_terms(_analysis(p_oa), port)
    assert dataclasses.asdict(rt) == dataclasses.asdict(pt)
    assert rt.describe() == pt.describe()


def test_kernel_points_identical(specs):
    ref, port = specs
    for rr, pr in zip(_records(r_ha), _records(p_oa)):
        assert ([dataclasses.asdict(p) for p in r_roof.kernel_points(rr, ref)]
                == [dataclasses.asdict(p)
                    for p in p_roof.kernel_points(pr, port)])


def test_attainable_identical(specs):
    ref, port = specs
    for ai in (0.1, 1.0, 30.0, 1e4):
        for level in ("hbm", ref.vmem.name):
            assert (r_roof.attainable(ai, ref, "bf16", level)
                    == p_roof.attainable(ai, port, "bf16", level))


@pytest.mark.parametrize("top_n", [3, 12])
def test_kernel_table_identical(specs, top_n):
    ref, port = specs
    assert (r_report.kernel_table(_analysis(r_ha), ref, top_n)
            == p_report.kernel_table(_analysis(p_oa), port, top_n))


def test_machine_table_identical(specs):
    ref, port = specs
    assert r_report.machine_table(ref) == p_report.machine_table(port)


@pytest.mark.parametrize("achieved", [None, [(10.0, 1e12), (0.5, 3e9)]])
def test_ascii_roofline_identical(specs, achieved):
    ref, port = specs
    assert (r_report.ascii_roofline(_records(r_ha), ref, title="t",
                                    achieved=achieved)
            == p_report.ascii_roofline(_records(p_oa), port, title="t",
                                       achieved=achieved))


def test_census_and_phase_tables_identical():
    ra, pa = _analysis(r_ha), _analysis(p_oa)
    assert ra.zero_ai_census() == pa.zero_ai_census()
    assert ra.total_flops_by_class == pa.total_flops_by_class
    census = {"fwd": ra.zero_ai_census(), "bwd": ra.zero_ai_census()}
    assert r_report.zero_ai_table(census) == p_report.zero_ai_table(census)
    payload = {"glm": {"fwd": {"wall_s": 0.01, "bound_overlap_s": 0.004,
                               "bound_serial_s": 0.006,
                               "achieved_flops_per_s": 3e12,
                               "pct_of_roofline": 0.4,
                               "dominant": "compute"}}}
    assert (r_report.achieved_table(payload)
            == p_report.achieved_table(payload))
    terms = {"x/fwd": r_roof.roofline_terms(ra, r_machine.TPU_V5E)}
    assert r_report.terms_table(terms) == p_report.terms_table(terms)


def test_ai_and_totals_match_reference_record():
    for rr, pr in zip(_records(r_ha), _records(p_oa)):
        for level in ("hbm", "vmem"):
            assert rr.ai(level) == pr.ai(level)
        assert rr.total_flops == pr.total_flops
        assert rr.is_zero_ai == pr.is_zero_ai


@pytest.mark.parametrize("name,sheet,bf16,f32,hbm", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm", 989e12, 67e12, 3.35e12),
    ("NVIDIA H100 PCIe", "h100-pcie", 756e12, 51e12, 2.0e12),
    ("NVIDIA H100 NVL", "h100-nvl", 835e12, 60e12, 3.9e12),
])
def test_h100_datasheet_by_device_name(name, sheet, bf16, f32, hbm):
    spec = p_machine.datasheet_for(name)
    assert spec.name == sheet and not spec.empirical
    assert spec.peak_flops["bf16"] == bf16 and spec.peak_flops["f32"] == f32
    assert spec.hbm.bytes_per_s == hbm
    assert [lv.name for lv in spec.mem_levels] == ["l2", "hbm"]
    assert spec.vmem.name == "l2"
    # int8/fp8 keep their datasheet rate, not the bf16 one
    assert spec.peak_flops["int8"] == 2 * bf16


def test_unknown_card_has_no_datasheet():
    with pytest.raises(KeyError, match="no datasheet"):
        p_machine.datasheet_for("NVIDIA A100-SXM4-80GB")


def test_port_holds_no_tpu_spec():
    assert not any(n.startswith("tpu") for n in p_machine.MACHINES)


def test_h100_report_keys_levels_by_name():
    spec = p_machine.H100_SXM
    text = p_report.ascii_roofline(_records(p_oa), spec)
    assert "markers: h/H=HBM l/L=L2" in text
    assert "-=HBM .=L2" in text
    assert "AI_l2" in p_report.kernel_table(_analysis(p_oa), spec)
    assert "memory/l2" in p_report.machine_table(spec)


def test_with_empirical_overwrites_named_levels():
    spec = p_machine.H100_SXM.with_empirical(
        {"f32": 50e12}, {"l2": 7e12, "hbm": 3e12})
    assert spec.empirical
    assert spec.level("l2").bytes_per_s == 7e12
    assert spec.hbm.bytes_per_s == 3e12
    assert spec.peak_flops["f32"] == 50e12
    assert spec.peak_flops["int8"] == p_machine.H100_SXM.peak_flops["int8"]
