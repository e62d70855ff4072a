"""The port's paper benchmarks (``repro_torch.bench``) on the host.

* Every suite runs with ``device="cpu"`` and emits the reference's row
  names (``benchmarks/*.py``), except where a row is a TPU figure — the
  datasheet's memory levels are the card's (``l2`` for ``vmem``), the
  ladder's rungs Hopper's (tensor-core GEMM for MXU), the library GEMM
  ``torch.matmul`` for XLA's einsum beside the hand-written kernel's
  rows, the Eq-3 peak the H100's (``gemm_sweep.py``'s docstring).
* The census keeps the reference's orderings: DeepCAM's fused lowering
  has fewer zero-AI launches than its reference lowering, the LM step at
  ``static`` fewer than at ``off``.  So does the AMP study: O1 moves more
  than 0.3 of the FLOPs to bf16, and O1's bound is at most 1.05× O0's.
* Each phase's dense (conv + matmul) FLOPs by ceiling class equal the
  reference's HLO count, exactly: the LM phases (``granite-8b``'s bwd
  under O0/O1/O2; ``glm4-9b``'s fwd / bwd / opt at ``off``, and at
  ``static`` against the reference's ``off`` plus the one-hot product of
  the embedding's fused backward — the reference's Pallas kernels do not
  lower on this jax, and change no product); DeepCAM's fwd and bwd with
  the differences ``ROADMAP.md`` §3 records held exactly — XLA's 1×1 convs as dots (both sides sum conv
  and matmul), the resize's dots (the port's upsample counts as
  elementwise), and the zeros XLA counts in each strided conv's input
  gradient (3× that conv's forward FLOPs, all but the stem).
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as r_base
from repro.configs import deepcam as r_dc_cfg
from repro.configs.registry import get_smoke as r_get_smoke
from repro.core import profile_fn as r_profile_fn
from repro.models import api as r_api
from repro.models import deepcam as r_dc
from repro.models.params import abstract as r_abstract
from repro_torch.bench import __main__ as bench_main
from repro_torch.bench import amp_study, zero_ai_census
from repro_torch.configs import deepcam as p_dc_cfg
from repro_torch.models import deepcam as p_dc
from repro_torch.session.session import Session

#: the reference's row names per suite (``benchmarks/*.py``); a comment
#: marks each name that is a TPU figure there and the port's in its place
REF_ROWS = {
    "ert_ceilings": [
        "datasheet_bf16", "datasheet_f32", "datasheet_int8",
        "datasheet_l2_bw",               # TPU: datasheet_vmem_bw
        "datasheet_hbm_bw", "datasheet_ici_bw",
        "empirical_f32_chain", "empirical_bf16_chain", "empirical_gemm512",
        "empirical_dram_bw", "empirical_cache_bw",
        "tuned_f32", "tuned_bf16", "tuned_dram_bw", "tuned_cache_bw",
        "frac_of_peak_flops_f32_before_after",
        "frac_of_peak_flops_bf16_before_after",
        "frac_of_peak_gemm_bf16_before_after"],
    "ert_ladder": [                      # TPU: VPU chains, MXU gemms
        "v1_fp32_chain_(ilp=1)", "v2_fp32_chain_(ilp=8)",
        "v3_bf16_packed_chain_(ilp=8)", "v4_tensor-core_gemm_128",
        "v5_tensor-core_gemm_256", "ascends"],
    "gemm_sweep": [
        "eq3_h100_peak",                 # TPU: eq3_v5e_peak
        "ert_gemm_128", "torch_matmul_128",   # TPU: xla_<size>
        "ert_gemm_256", "torch_matmul_256",
        "rises_with_size",
        "ert_gemm_vs_ref_maxerr",        # TPU: pallas_vs_ref_maxerr
        "ert_gemm_config"],              # TPU: pallas_config
    "deepcam_roofline": [
        "reference_fwd", "reference_bwd", "reference_opt", "fused_fwd",
        "fused_bwd", "fused_opt", "bwd_gt_fwd_flops", "opt_memory_bound",
        "conv_flop_share", "conv_resize_flop_share"],
    "amp_study": [
        "deepcam_O0", "deepcam_O1", "deepcam_O2", "lm_O0", "lm_O1",
        "lm_O2", "deepcam_O1_moves_flops_to_bf16",
        "deepcam_O1_bound_leq_O0", "lm_O1_moves_flops_to_bf16",
        "lm_O1_bound_leq_O0"],
    "zero_ai_census": [
        "reference_fwd", "reference_bwd", "fused_fwd", "fused_bwd",
        "reference_vs_fused", "lm_fwd_reference", "lm_bwd_reference",
        "lm_opt_reference", "lm_fwd_fused", "lm_bwd_fused", "lm_opt_fused",
        "lm_fwd_delta", "lm_bwd_delta", "lm_opt_delta",
        "lm_step_reference_vs_fused"],
    "train_throughput": [
        "minitron-4b", "glm4-9b", "mamba2-1.3b", "zamba2-1.2b",
        "granite-moe-1b-a400m", "seamless-m4t-large-v2"],
}
_PREFIX = {"zero_ai_census": "zero_ai"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small ops: the test run
    puts several workers on the host's cores, and a pool of as many
    threads as cores then waits at every op on threads that another
    worker holds (tens of times slower).  The checks hold at any thread
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every paper suite on the host, in a fresh workspace (the gates and
    smokes: ``test_torch_bench_gates.py``, ``test_torch_bench_smokes.py``)."""
    ws = str(tmp_path_factory.mktemp("ws"))
    old = os.environ.get("REPRO_WORKSPACE")
    os.environ["REPRO_WORKSPACE"] = ws
    try:
        yield bench_main.run(tuple(REF_ROWS), "cpu")
    finally:
        if old is None:
            os.environ.pop("REPRO_WORKSPACE")
        else:
            os.environ["REPRO_WORKSPACE"] = old


def _rows(results, suite) -> dict:
    return {n: d for n, _, d in results[suite]["rows"]}


def _reference_suites() -> tuple[str, ...]:
    """``benchmarks/run.py``'s ``SUITES``, read from its source (the
    reference's benchmarks are not a package on the path)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmarks", "run.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "SUITES"
                        for t in n.targets))
    return ast.literal_eval(node.value)


def test_suites_are_the_ported_ones():
    """The reference's suites, all 21, in its order (``net_smoke`` last);
    the paper's among them."""
    ref = _reference_suites()
    assert len(ref) == 21 and ref[-1] == "net_smoke"
    assert bench_main.SUITES == tuple(ref)
    assert set(REF_ROWS) <= set(bench_main.SUITES)


@pytest.mark.parametrize("suite", list(REF_ROWS))
def test_suite_runs_on_the_host_with_the_reference_rows(results, suite):
    assert results[suite]["ok"]
    prefix = _PREFIX.get(suite, suite)
    assert [n for n, _, _ in results[suite]["rows"]] == \
        [f"{prefix}/{n}" for n in REF_ROWS[suite]]


def test_census_keeps_the_reference_orderings(results):
    rows = _rows(results, "zero_ai_census")
    zr, zf = map(int, rows["zero_ai/reference_vs_fused"].split("vs"))
    assert zf < zr
    step = dict(kv.split("=") for kv in
                rows["zero_ai/lm_step_reference_vs_fused"].split(";"))
    z_off, z_static = map(int, step["zero"].split("vs"))
    assert z_static < z_off
    assert float(step["zero_reduction"]) > 0


def test_amp_study_keeps_the_reference_orderings(results):
    rows = _rows(results, "amp_study")
    for tag in ("deepcam", "lm"):
        assert rows[f"amp_study/{tag}_O1_moves_flops_to_bf16"] == "True"
        assert rows[f"amp_study/{tag}_O1_bound_leq_O0"] == "True"


def test_gemm_sweep_kernel_agrees_with_matmul_ref(results):
    rows = _rows(results, "gemm_sweep")
    err = float(rows["gemm_sweep/ert_gemm_vs_ref_maxerr"].split(";")[0])
    assert err == 0.0                    # the plain version is matmul_ref
    assert rows["gemm_sweep/eq3_h100_peak"].startswith("1070.5TFLOPs")


def test_cli_lists_and_writes_under_the_workspace_only(tmp_path, monkeypatch,
                                                       capsys):
    monkeypatch.setenv("REPRO_WORKSPACE", str(tmp_path / "ws"))
    monkeypatch.chdir(tmp_path)
    assert bench_main.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(bench_main.SUITES)
    assert bench_main.main(["--only", "ert_ladder,amp_study",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # the host's timings are noise: the row is held, not its verdict
    assert "ert_ladder/ascends,0.0," in out and "amp_study/lm_O2" in out
    files = os.listdir(tmp_path / "ws" / "bench")
    assert len(files) == 1 and files[0].startswith("BENCH_")
    assert sorted(os.listdir(tmp_path)) == ["ws"]
    doc = json.loads((tmp_path / "ws" / "bench" / files[0]).read_text())
    assert list(doc["suites"]) == ["ert_ladder", "amp_study"]
    assert doc["device"] == "cpu"
    assert bench_main.main(["--only", "nope"]) == 2


# --------------------------------------------------------------------------
# FLOPs by class against the reference's HLO count
# --------------------------------------------------------------------------

def _dense(kernels, skip=lambda k: False) -> dict:
    out: dict = {}
    for k in kernels:
        if k.category in ("conv", "matmul") and not skip(k):
            for cls, f in k.flops_by_class.items():
                out[cls] = out.get(cls, 0.0) + f * k.exec_count
    return out


def _matmul_class(amp: str) -> str | None:
    """The AMP policy's class of a product's f32 operands, as both
    packages' sessions pass it: XLA's CPU backend computes a bf16 dot in
    f32, so the HLO alone would class O1's products f32."""
    return None if amp == "O0" else "bf16"


def _ref_deepcam(amp: str, phase: str):
    """The reference's DeepCAM phase (the amp study's and the census's:
    width 8 on SMOKE_HW, batch 2), profiled on abstract shapes."""
    run = r_base.RunConfig(amp=amp)
    params = r_abstract(r_dc.deepcam_spec(8))
    images = jax.ShapeDtypeStruct((2, *r_dc_cfg.SMOKE_HW, 16), jnp.float32)
    labels = jax.ShapeDtypeStruct((2, *r_dc_cfg.SMOKE_HW), jnp.int32)

    def fwd(p, x, y):
        return r_dc.deepcam_loss(p, x, y, run)

    fn = fwd if phase == "fwd" else jax.grad(fwd)
    return r_profile_fn(fn, args=(params, images, labels),
                        name=f"deepcam/{phase}",
                        matmul_class=_matmul_class(amp)).analysis.kernels


def _ref_lm(config: str, amp: str, seq: int, batch: int) -> dict:
    """{phase: kernels} of the reference's LM train-step phases at
    ``fusion="off"``, on abstract shapes."""
    from repro.trace.cli import build_phase_args
    run = r_base.RunConfig(amp=amp)
    phases = build_phase_args(r_api.build(r_get_smoke(config)), run,
                              seq=seq, batch=batch, concrete=False)
    return {ph: r_profile_fn(fn, args=args, name=ph,
                             matmul_class=_matmul_class(amp)).analysis.kernels
            for ph, (fn, args) in phases.items()}


def _strided_zeros() -> float:
    """The zeros XLA counts in the strided convs' input gradients."""
    return float(sum(3 * 2 * 2 * h * w * k * k * cin * cout
                     for name, h, w, k, cin, cout, s in
                     p_dc.conv_plan(8, p_dc_cfg.SMOKE_HW)
                     if s == 2 and name != "stem"))


@pytest.fixture(scope="module")
def port_amp_walks():
    return amp_study.bwd_walks("cpu")


@pytest.mark.parametrize("amp", ["O0", "O1", "O2"])
def test_amp_study_deepcam_bwd_flops_by_class(amp, port_amp_walks):
    ref = _ref_deepcam(amp, "bwd")
    r_all = _dense(ref)
    r_resize = _dense([k for k in ref if "_resize" in k.op_name])
    got = _dense(port_amp_walks[("deepcam", amp)].analysis.kernels)
    assert set(got) == set(r_all) and len(got) == 1
    (cls,) = got
    assert cls == ("f32" if amp == "O0" else "bf16")
    assert r_resize[cls] > 0
    assert got[cls] == r_all[cls] - r_resize[cls] - _strided_zeros()


@pytest.mark.parametrize("amp", ["O0", "O1", "O2"])
def test_amp_study_lm_bwd_flops_by_class(amp, port_amp_walks):
    ref = _ref_lm("granite-8b", amp, 64, 4)["bwd"]
    got = _dense(port_amp_walks[("lm", amp)].analysis.kernels)
    assert got == _dense(ref) and sum(got.values()) > 0


def test_census_deepcam_fwd_flops_by_class():
    ref = _ref_deepcam("O1", "fwd")
    r_resize = _dense([k for k in ref if "_resize" in k.op_name])["bf16"]
    prof = Session(machine=zero_ai_census.MACHINE, device="cpu").profile(
        "deepcam", phases=("fwd",), smoke=True, batch=2, amp="O1")
    got = _dense(prof.analyses["fwd"].kernels)
    assert got == {"bf16": _dense(ref)["bf16"] - r_resize}
    assert got["bf16"] == p_dc.conv_flops(8, p_dc_cfg.SMOKE_HW, 2)


def test_census_lm_phases_flops_by_class():
    """At ``static`` the embedding's backward is one ``onehotᵀ @ g``
    product in both packages (``embed_with_onehot_grad``, a ``custom_vjp``
    of jnp ops in the reference, not a Pallas kernel), where ``off``
    scatters: the bwd gains exactly its 2·(B·S)·V·D FLOPs."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import api as p_api
    ref = _ref_lm(zero_ai_census.LM_CONFIG, "O1", zero_ai_census.LM_SEQ,
                  zero_ai_census.LM_BATCH)
    vocab, d = p_api.build(get_smoke(zero_ai_census.LM_CONFIG)).spec[
        "embed"]["tokens"].shape
    onehot = 2.0 * zero_ai_census.LM_BATCH * zero_ai_census.LM_SEQ * vocab * d
    s = Session(machine=zero_ai_census.MACHINE, device="cpu")
    for fusion in zero_ai_census.FUSION_MODES:
        prof = s.profile(zero_ai_census.LM_CONFIG, smoke=True,
                         seq=zero_ai_census.LM_SEQ,
                         batch=zero_ai_census.LM_BATCH, amp="O1",
                         fusion=fusion)
        for ph in ("fwd", "bwd", "opt"):
            want = _dense(ref[ph])
            if fusion == "static" and ph == "bwd":
                want = {"bf16": want["bf16"] + onehot}
            assert _dense(prof.analyses[ph].kernels) == want, (fusion, ph)
    assert _dense(ref["opt"]) == {} and _dense(ref["fwd"])["bf16"] > 0
