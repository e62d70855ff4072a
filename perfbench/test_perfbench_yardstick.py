"""The frozen yardstick against hand counts at the cells' shapes, and the
per-layer readers on a trace built by hand."""

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import yardstick as ys
from perfbench.reference import dense, mamba2
from perfbench.trace import Trace

METRICS = Path(__file__).resolve().parent / "metrics"
GLM = {"n_layers": 4, "d_model": 4096, "n_heads": 32, "n_kv_heads": 2,
       "head_dim": 128, "d_ff": 13696, "vocab_size": 151552}
MAMBA = {"n_layers": 48, "d_model": 2048, "vocab_size": 50280,
         "ssm_state": 128, "ssm_expand": 2, "ssm_head_dim": 64,
         "ssm_n_groups": 1, "ssm_conv_width": 4, "ssm_chunk": 256}


def test_ssd_needed_flops_at_the_mamba_cell():
    # nc = 8 chunks of 256, 32,896 causal pairs a chunk:
    # C·Bᵀ 2·8·2·32,896·128 = 134,742,016; per head
    # 8·32,896·129 + 2·7·2·256·64·128 = 92,668,928, times 2·64 heads
    assert ys.ssd_needed_flops(2, 64, 2048, 64, 128, 256) == \
        134_742_016 + 128 * 92_668_928 == 11_996_364_800


def test_ssd_bytes_count_each_operand_once():
    # x and y 2·2048·64·64 each, a 2·2048·64, B and C 2·2048·128 each
    assert ys.ssd_bytes(2, 64, 2048, 64, 128) == 4 * (
        2 * 2 * 2048 * 64 * 64 + 2 * 2048 * 64 + 2 * 2 * 2048 * 128)


def test_flash_counts_at_the_glm_cell():
    assert ys.flash_flops(1, 32, 4096, 128) == 2 * 32 * 4096 ** 2 * 128
    # q and o at 32 heads, k and v at their 2 KV heads, bf16
    q = 4096 * 32 * 128 * 2
    kv = 4096 * 2 * 128 * 2
    assert ys.flash_bytes(1, 4096, 32, 2, 128, 2) == 2 * q + 2 * kv \
        == 71_303_168
    # K/V read once per query head would be 16× the K/V bytes
    assert ys.flash_bytes(1, 4096, 32, 2, 128, 2) < 2 * q + 2 * 16 * kv


def test_norm_and_adamw_bytes():
    assert ys.rmsnorm_bytes(4096, 4096, 2, False) == \
        2 * 4096 * 4096 * 2 + 4096 * 4 == 67_125_248
    assert ys.rmsnorm_bytes(4096, 4096, 2, True) == \
        4 * 4096 * 4096 * 2 + 4096 * 4
    assert ys.adamw_bytes(1000) == 7 * 1000 * 4 + 8


def test_model_flops_of_the_glm_cell():
    per_layer = (2 * 4096 * 32 * 128 + 2 * 4096 * 2 * 128
                 + 3 * 4096 * 13696)
    assert per_layer == 203_948_032
    weights = 4 * per_layer + 4096 * 151552
    assert dense.weights_per_token(GLM) == weights == 1_436_549_120
    attn = 4 * 6 * 32 * 4096 ** 2 * 128
    assert dense.model_flops(GLM, 1, 4096) == \
        6 * 4096 * weights + attn
    assert 36.9e12 < dense.model_flops(GLM, 1, 4096) < 37.0e12


def test_model_flops_of_the_mamba_cell():
    per_layer = 2048 * 8512 + 4 * 4352 + 4096 * 2048
    weights = 48 * per_layer + 2048 * 50280
    assert mamba2.weights_per_token(MAMBA) == weights == 1_343_225_856
    assert mamba2.model_flops(MAMBA, 2, 2048) == \
        6 * 4096 * weights + 3 * 48 * 11_996_364_800
    assert 34.7e12 < mamba2.model_flops(MAMBA, 2, 2048) < 34.8e12


@pytest.mark.parametrize("shape", [(2, 64, 2048, 64, 128, 256),
                                   (1, 8, 512, 16, 16, 128),
                                   (3, 4, 1024, 32, 64, 64)])
def test_ssd_copy_equals_the_programs_needed_flops(shape):
    from repro_torch.kernels.ssd_scan import kernel as sk
    assert ys.ssd_needed_flops(*shape) == sk.needed_flops(*shape)
    # the program's op-walk model counts whole chunk² tiles: more
    assert ys.ssd_needed_flops(*shape) < sk.flops(*shape)


def test_flash_bytes_below_the_programs_model():
    from repro_torch.kernels.flash_attention import kernel as fk
    # the program's model reads K/V once per query head
    assert ys.flash_bytes(1, 4096, 32, 2, 128, 2) < \
        fk.hbm_bytes(32, 4096, 4096, 128, 2)


def test_bound_is_the_larger_term_and_no_count_beats_its_peak():
    p = ys.H100_SXM
    flops, nbytes = ys.flash_flops(1, 32, 4096, 128), \
        ys.flash_bytes(1, 4096, 32, 2, 128, 2)
    b = ys.bound_s(flops, nbytes, p["bf16"], p["hbm"])
    assert b == max(flops / p["bf16"], nbytes / p["hbm"])
    assert b >= flops / p["bf16"] and b >= nbytes / p["hbm"]
    # the peaks are the data sheet's, and the scan's is TF32's
    assert (p["bf16"], p["tf32"], p["fp32"], p["hbm"]) == \
        (989e12, 495e12, 67e12, 3.35e12)


class _Ev:
    """A profiler event, as ``Trace`` reads one."""

    def __init__(self, name, kind, start, end, corr=0, linked=0, tid=1,
                 shapes=(), dtypes=()):
        self._v = (name, kind, start, end, corr, linked, tid, list(shapes),
                   list(dtypes))

    def name(self): return self._v[0]
    def activity_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]
    def shapes(self): return self._v[7]
    def dtypes(self): return self._v[8]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(events, **kw):
    tr = Trace(events)
    ns = dict(trace=tr, peaks=ys.H100_SXM, model=MAMBA, family="mamba2",
              reference=mamba2,
              mix={"batch": 2, "seq_len": 2048}, params=1000, phase_ms={},
              steps=0, window_s=0.0, busy_s=0.0, traced_s=0.0)
    ns.update(kw)
    return SimpleNamespace(**ns)


def test_flash_reader_takes_the_calls_kernels_and_shapes():
    q, k = [1, 4096, 2, 16, 128], [1, 4096, 2, 128]
    bound = ys.bound_s(ys.flash_flops(1, 32, 4096, 128),
                       ys.flash_bytes(1, 4096, 32, 2, 128, 2),
                       989e12, 3.35e12)
    t = int(round(bound * 2e9))             # the kernel takes 2× its bound
    events = [
        _Ev("outer", "cpu_op", 0, 10 ** 9, corr=1),
        _Ev("repro_torch::flash_attention", "cpu_op", 10, 10 ** 8, corr=2,
            shapes=[q, k, k, []], dtypes=["c10::BFloat16"] * 3 + ["Scalar"]),
        _Ev("aten::empty", "cpu_op", 20, 30, corr=3),
        _Ev("flash_fwd_wgmma_kernel", "kernel", 1000, 1000 + t, linked=2),
        # a kernel of another op is not counted
        _Ev("other", "kernel", 10 ** 8 + 10, 10 ** 8 + 5000, linked=1),
    ]
    share = _reader("flash_roofline_pct.train").read(_ctx(events))
    assert share == pytest.approx(50.0, rel=1e-6)
    # no flash call in the trace: nothing to read
    assert _reader("flash_roofline_pct.train").read(_ctx(events[:1])) is None


def test_ssd_reader_counts_every_launch_of_a_call():
    xh, a, bc = [2, 2048, 64, 64], [2, 2048, 64], [2, 2048, 128]
    bound = ys.bound_s(ys.ssd_needed_flops(2, 64, 2048, 64, 128, 256),
                       ys.ssd_bytes(2, 64, 2048, 64, 128), 495e12, 3.35e12)
    t = int(round(bound * 1e9))
    events = [
        _Ev("repro_torch::ssd_scan", "cpu_op", 0, 10 ** 9, corr=5,
            shapes=[xh, a, bc, bc, []], dtypes=["float"] * 4 + ["Scalar"]),
        # three launches
        _Ev("ssd_chunk_kernel", "kernel", 100, 100 + t, linked=5),
        _Ev("ssd_pass_kernel", "kernel", 200 + t, 200 + 2 * t, linked=5),
        _Ev("cudaLaunchKernel", "cuda_runtime", 50, 60, corr=99),
        _Ev("ssd_out_kernel", "kernel", 300 + 2 * t, 300 + 3 * t, linked=5),
        # a kernel with no link to an op is nobody's
        _Ev("stray_kernel", "kernel", 400 + 3 * t, 400 + 4 * t, corr=99),
    ]
    share = _reader("ssd_roofline_pct.train").read(_ctx(events))
    assert share == pytest.approx(100.0 / 3, rel=1e-6)


def test_norm_adamw_idle_and_mfu_readers():
    events = [
        _Ev("repro_torch::rmsnorm", "cpu_op", 0, 1000, corr=1,
            shapes=[[4096, 4096], [4096], [], []],
            dtypes=["c10::BFloat16", "float", "Scalar", "Scalar"]),
        _Ev("rmsnorm_kernel", "kernel", 0, 40_075, linked=1),
        _Ev("repro_torch::adamw_multi_", "cpu_op", 2000, 3000, corr=2),
        _Ev("adamw_kernel", "kernel", 50_000, 150_000, linked=2),
    ]
    ctx = _ctx(events, params=10 ** 7, busy_s=0.75, traced_s=1.0,
               steps=10, window_s=20.0)
    norm = _reader("rmsnorm_roofline_pct.train").read(ctx)
    assert norm == pytest.approx(100 * 67_125_248 / 3.35e12 / 40_075e-9)
    adam = _reader("adamw_roofline_pct.train").read(ctx)
    assert adam == pytest.approx(100 * (28e7 + 8) / 3.35e12 / 1e-4)
    assert _reader("idle_pct.train").read(ctx) == pytest.approx(25.0)
    mfu = _reader("mfu_pct.train").read(ctx)
    assert mfu == pytest.approx(
        100 * mamba2.model_flops(MAMBA, 2, 2048) * 10 / 20 / 989e12)
    assert _reader("fwd_ms.train").read(ctx) is None
    ctx.phase_ms = {"fwd": [1.0, 3.0], "bwd": [5.0], "opt": [2.0]}
    assert [_reader(n).read(ctx) for n in
            ("fwd_ms.train", "fwd_bwd_ms.train", "opt_ms.train")] == \
        [2.0, 5.0, 2.0]


def test_trace_busy_gaps_and_top_ops():
    events = [
        _Ev("phase:fwd", "user_annotation", 0, 1000, corr=1),
        _Ev("aten::mm", "cpu_op", 100, 200, corr=2),
        _Ev("k1", "kernel", 100, 300, linked=2),
        _Ev("k2", "kernel", 250, 400, linked=2),
        _Ev("k1", "kernel", 700, 800, linked=2),
    ]
    tr = Trace(events)
    assert tr.busy_s(0, 1000) == pytest.approx(400e-9)
    assert tr.device_ops()[0] == ["k1", pytest.approx(300e-9)]
    gaps = tr.idle_gaps(0, 1000)
    assert gaps[0][1] == pytest.approx(300e-9)        # 400 to 700
    assert gaps[0][0] == "phase:fwd | then k1"
    assert math.isclose(sum(g[1] for g in gaps), 600e-9)
    marked = tr.idle_gaps(0, 1000, marks=[(0, "fwd"), (500, "bwd")])
    assert marked[0][0] == "bwd | phase:fwd | then k1"
    assert marked[1][0] == "bwd | phase:fwd | then the window's end"


def test_short_names():
    from perfbench.trace import short
    assert short("void (anonymous namespace)::flash_fwd_wgmma_kernel"
                 "<__nv_bfloat16>(CUtensorMap, float)") == \
        "flash_fwd_wgmma_kernel<__nv_bfloat16>"
    assert short("Memset (Device)") == "Memset"
    assert short("void at::native::reduce_kernel<512, 1, at::native::"
                 "ReduceOp<float, f(int)> >(at::native::ReduceOp)") == \
        "reduce_kernel<512, 1, ReduceOp<float, f(int)> >"
