"""The program's spans (``repro_torch.trace.spans``): each hand-written
backward runs inside ``repro_torch::<op>.bwd`` under the profiler, with
its recompute nested in the span, and builds no ``RecordFunction`` when
no profiler runs."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
from repro_torch.kernels.fused import ops as fo
from repro_torch.kernels.ssd_scan.ops import ssd_scan_model_layout
from repro_torch.trace.spans import SPANS, backward_span


def _inputs(op: str, g: torch.Generator) -> tuple:
    def r(*shape):
        return torch.randn(*shape, generator=g)
    if op == "flash_attention":
        return r(1, 32, 2, 2, 8), r(1, 32, 2, 8), r(1, 32, 2, 8)
    if op == "ssd_scan":
        return (r(1, 16, 2, 4), -torch.rand(1, 16, 2, generator=g),
                r(1, 16, 3), r(1, 16, 3))
    if op == "rmsnorm_residual":
        return r(6, 16), r(6, 16), r(16)
    if op == "layernorm":
        return r(6, 16), r(16), r(16)
    if op == "swiglu":
        return r(6, 16), r(6, 16)
    return r(6, 16), r(16)


#: each op, its call, and an op of the plain recompute that the forward
#: on a CPU tensor runs as often (so as often under the span as outside)
CASES = {
    "flash_attention": (flash_attention_gqa, "aten::softmax"),
    "ssd_scan": (lambda *t: ssd_scan_model_layout(*t, chunk=8),
                 "aten::einsum"),
    "rmsnorm": (fo.rmsnorm, "aten::rsqrt"),
    "rmsnorm_residual": (lambda x, h, s: sum(fo.rmsnorm_residual(x, h, s)),
                         "aten::rsqrt"),
    "layernorm": (fo.layernorm, "aten::var"),
    "swiglu": (fo.swiglu, "aten::sigmoid"),
}


def _grads(op: str) -> tuple:
    fn = CASES[op][0]
    xs = [t.requires_grad_() for t in _inputs(op, torch.Generator()
                                               .manual_seed(3))]
    y = fn(*xs)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    return torch.autograd.grad((y * w).sum(), xs)


def _descendants(event) -> list:
    out = []
    for child in event.cpu_children:
        out += [child, *_descendants(child)]
    return out


@pytest.mark.parametrize("op", sorted(CASES))
def test_each_backward_runs_inside_its_span(op):
    span = f"repro_torch::{op}.bwd"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _grads(op)
    events = prof.events()
    spans = [e for e in events if e.name == span]
    assert len(spans) == 1, [e.name for e in events if ".bwd" in e.name]
    inner = _descendants(spans[0])
    assert any(e.name.startswith("aten::") for e in inner)
    mark = CASES[op][1]
    # the recompute's copy of the plain op is under the span; the
    # forward's is not
    n = sum(e.name == mark for e in inner)
    assert n >= 1 and sum(e.name == mark for e in events) == 2 * n
    # no other op's span, and no span of this op outside the backward
    assert {e.name for e in events if e.name.endswith(".bwd")} == {span}


@pytest.mark.parametrize("op", sorted(CASES))
def test_no_profiler_builds_no_span_and_the_gradients_are_the_same(
        op, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _grads(op)

    def refuse(*args, **kwargs):
        raise AssertionError("a span was built with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    plain = _grads(op)
    assert all(torch.equal(a, b) for a, b in zip(traced, plain, strict=True))


def test_the_spans_are_the_six_backwards():
    assert sorted(SPANS) == sorted(f"repro_torch::{op}.bwd" for op in CASES)
    with pytest.raises(ValueError):
        backward_span("repro_torch::adamw_multi_")
