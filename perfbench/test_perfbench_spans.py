"""The readers of the program's backward spans (``metrics/*_bwd_*``) on
traces built by hand: the device work launched inside a
``repro_torch::<op>.bwd`` span counts, and nothing else does."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench.trace import Trace

METRICS = Path(__file__).resolve().parent / "metrics"
READERS = ("attn_bwd_ms.train", "ssd_bwd_ms.train", "fused_bwd_ms.train",
           "bwd_launches.train")
FLASH_BWD = "repro_torch::flash_attention.bwd"
SSD_BWD = "repro_torch::ssd_scan.bwd"


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
        "s_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(name, events):
    return _reader(name).read(SimpleNamespace(trace=Trace(events)))


def _forward():
    """The flash op's forward on the main thread, with its kernel."""
    return [
        _Ev("phase:bwd", "user_annotation", 0, 10 ** 7, corr=1),
        _Ev("repro_torch::flash_attention", "cpu_op", 10, 1000, corr=2),
        _Ev("flash_fwd_wgmma_kernel", "kernel", 100, 50_100, linked=2),
    ]


def _span(name, t, corr, kernel_ns, tid=2):
    """One call of the span ``name`` at ``t`` on the autograd thread: an
    aten op inside it launches a kernel of ``kernel_ns`` and a copy of
    1 µs."""
    return [
        _Ev(name, "user_annotation", t, t + 10 ** 5, corr=corr, tid=tid),
        _Ev("aten::mm", "cpu_op", t + 10, t + 100, corr=corr + 1, tid=tid),
        _Ev("sm80_xmma_gemm_f32f32", "kernel", t + 200, t + 200 + kernel_ns,
            linked=corr + 1),
        _Ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy",
            t + 300 + kernel_ns, t + 1300 + kernel_ns, linked=corr + 1),
    ]


def test_a_spans_device_work_counts_and_the_forwards_does_not():
    events = _forward() + _span(FLASH_BWD, 10 ** 6, 10, 2_000_000) + [
        # the span's copy on the device timeline: an annotation, not work
        _Ev(FLASH_BWD, "gpu_user_annotation", 10 ** 6, 10 ** 6 + 10 ** 5),
        _Ev(FLASH_BWD, "kernel", 10 ** 6, 10 ** 6 + 10 ** 5),
    ]
    assert _read("attn_bwd_ms.train", events) == pytest.approx(2.001)
    assert _read("bwd_launches.train", events) == 2
    # the span is no device operation and no busy time
    tr = Trace(events)
    assert FLASH_BWD not in {name for name, _ in tr.device_ops()}
    assert tr.busy_s(0, 10 ** 7) == pytest.approx((50_000 + 2_001_000)
                                                  * 1e-9)


def test_two_calls_sum():
    events = (_forward() + _span(SSD_BWD, 10 ** 6, 10, 300_000)
              + _span(SSD_BWD, 3 * 10 ** 6, 20, 700_000))
    assert _read("ssd_bwd_ms.train", events) == pytest.approx(1.002)
    assert _read("bwd_launches.train", events) == 4


def test_the_four_fused_spans_sum_and_launches_count_copies_and_memsets():
    events = _forward()
    for i, op in enumerate(("rmsnorm", "rmsnorm_residual", "layernorm",
                            "swiglu")):
        events += _span(f"repro_torch::{op}.bwd", (i + 1) * 10 ** 6,
                        10 * (i + 1), 10_000)
    events += _span(FLASH_BWD, 6 * 10 ** 6, 90, 10_000)
    events.append(_Ev("Memset (Device)", "gpu_memset", 6_500_000, 6_500_500,
                      linked=91))
    assert _read("fused_bwd_ms.train", events) == pytest.approx(4 * 0.011)
    assert _read("attn_bwd_ms.train", events) == pytest.approx(0.0115)
    # 5 spans × (a kernel and a copy), and the memset
    assert _read("bwd_launches.train", events) == 11


def test_no_span_reads_nothing():
    for name in READERS:
        assert _read(name, _forward()) is None
    # a span that launched nothing on the device reads nothing too
    idle = _forward() + [_Ev(SSD_BWD, "user_annotation", 10 ** 6,
                             2 * 10 ** 6, corr=9, tid=2)]
    assert _read("ssd_bwd_ms.train", idle) is None


@pytest.mark.parametrize("name", READERS)
def test_each_readers_spans_are_the_programs(name):
    from repro_torch.trace.spans import SPANS
    spans = _reader(name).SPANS
    assert spans and set(spans) <= set(SPANS)
    if name == "bwd_launches.train":
        assert set(spans) == set(SPANS)
