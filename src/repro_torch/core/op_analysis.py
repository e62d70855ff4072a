"""Application characterization from aten ops (port of ``core/hlo_analysis``).

The reference walks compiled HLO and emits one :class:`KernelRecord` per
executed fusion.  PyTorch runs eagerly, so its unit of launch is the aten
op: :func:`analyze_fn` runs the callable under a ``TorchDispatchMode`` on
**meta** tensors (the counterpart of the reference's ShapeDtypeStruct
path: nothing is allocated) and emits one record per op that launches a
kernel:

* view and alias ops (and bare allocations) launch nothing and are free;
* identical (op, shapes, dtypes) records are merged and ``exec_count``
  counts how often they ran — the counterpart of the reference's
  while-loop trip multiplier, which keeps a 40-layer table short;
* FLOPs: matmul-family ops and convolutions (forward and backward) by
  ``torch.utils.flop_counter``'s formulas — 2·B·H_out·W_out·k²·c_in·c_out
  a conv, the bias add not included; the backward counts only the
  gradients its ``output_mask`` asks for —, elementwise / reduction /
  transcendental ops by the reference's per-opcode rules
  (``hlo_analysis._op_flops``), composite aten ops by the sum of the HLO
  ops they stand for, and the bilinear upsample by what its kernel
  computes (:data:`UPSAMPLE_FLOPS`, :data:`UPSAMPLE_BWD_FLOPS`);
* categories are the reference's labels: ``matmul``, ``conv``,
  ``elementwise``, ``reduction``, ``custom`` and ``zero-ai``;
* the ceiling class comes from the operand dtype (:func:`dtype_class`);
* ``hbm_bytes`` = operand bytes + result bytes.  An unfused aten op is
  its own kernel, so every intermediate crosses device memory and
  ``vmem_bytes`` (the on-chip level's traffic) equals ``hbm_bytes``;
* the port's own ops (``repro_torch::``, one per hand-written kernel) are
  category ``custom`` — the reference's label for a custom call — with
  the FLOPs of the kernel module's count, and bytes = operands + results
  + the operands the op writes in place (the in-place AdamW update
  returns nothing but writes p, m and v); flash attention carries its
  module's ``hbm_bytes`` instead (K/V counted once per query head).
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Any, Callable, Sequence

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

aten = torch.ops.aten

# --------------------------------------------------------------------------
# Dtypes
# --------------------------------------------------------------------------

_DTYPE_NAMES = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bool: "pred", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2",
}


def dtype_name(dtype: torch.dtype) -> str:
    """HLO-style short name of a torch dtype (``bf16``, ``f32``, ...)."""
    return _DTYPE_NAMES.get(dtype, str(dtype).removeprefix("torch."))


def dtype_class(dtype: str) -> str:
    """Roofline ceiling class of a dtype name (same rule as the reference)."""
    if dtype in ("bf16", "f16"):
        return "bf16"
    if dtype.startswith("f8") or dtype in ("s8", "u8", "s4", "u4", "s2", "u2"):
        return "int8"
    return "f32"


# --------------------------------------------------------------------------
# Records (copied field for field from repro.core.hlo_analysis)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KernelRecord:
    """Per-kernel data of paper Table II, on aten-op granularity."""

    name: str
    opcode: str
    op_name: str                      # provenance: operand shapes
    exec_count: int                   # how often the identical op ran
    flops_by_class: dict[str, float]  # ceiling class → FLOPs (one execution)
    hbm_bytes: int                    # operand + result bytes (one execution)
    vmem_bytes: int                   # on-chip level traffic (one execution)
    category: str            # matmul|conv|elementwise|reduction|custom|zero-ai

    @property
    def flops(self) -> float:
        return sum(self.flops_by_class.values())

    @property
    def total_flops(self) -> float:
        return self.flops * self.exec_count

    @property
    def total_hbm_bytes(self) -> float:
        return float(self.hbm_bytes) * self.exec_count

    @property
    def total_vmem_bytes(self) -> float:
        return float(self.vmem_bytes) * self.exec_count

    @property
    def is_zero_ai(self) -> bool:
        return self.flops == 0.0

    def ai(self, level: str = "hbm") -> float:
        b = self.hbm_bytes if level == "hbm" else self.vmem_bytes
        return self.flops / b if b else math.inf


@dataclasses.dataclass
class CollectiveRecord:
    name: str
    opcode: str
    exec_count: int
    payload_bytes: int
    wire_bytes: float
    group_size: int
    cross_pod: bool

    @property
    def total_wire_bytes(self) -> float:
        return self.wire_bytes * self.exec_count


@dataclasses.dataclass
class ModuleAnalysis:
    kernels: list[KernelRecord]
    collectives: list[CollectiveRecord]

    @property
    def total_flops_by_class(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for k in self.kernels:
            for cls, f in k.flops_by_class.items():
                out[cls] += f * k.exec_count
        return dict(out)

    @property
    def total_flops(self) -> float:
        return sum(self.total_flops_by_class.values())

    @property
    def total_hbm_bytes(self) -> float:
        return sum(k.total_hbm_bytes for k in self.kernels)

    @property
    def total_vmem_bytes(self) -> float:
        return sum(k.total_vmem_bytes for k in self.kernels)

    def collective_wire_bytes(self, cross_pod: bool | None = None) -> float:
        return sum(c.total_wire_bytes for c in self.collectives
                   if cross_pod is None or c.cross_pod == cross_pod)

    def zero_ai_census(self) -> dict[str, tuple[int, int]]:
        """Paper Table III: {zero-AI: (invocations, bytes), non zero-AI: ...}."""
        z_inv = z_bytes = n_inv = n_bytes = 0
        for k in self.kernels:
            if k.is_zero_ai:
                z_inv += k.exec_count
                z_bytes += int(k.total_hbm_bytes)
            else:
                n_inv += k.exec_count
                n_bytes += int(k.total_hbm_bytes)
        return {"zero-AI": (z_inv, z_bytes), "non zero-AI": (n_inv, n_bytes)}


# --------------------------------------------------------------------------
# Per-op rules
# --------------------------------------------------------------------------

# launch nothing: views, aliases and bare allocations
_FREE = {
    aten.view, aten._unsafe_view, aten.expand, aten.permute, aten.transpose,
    aten.t, aten.slice, aten.select, aten.unsqueeze, aten.squeeze,
    aten.as_strided, aten.alias, aten.detach, aten._reshape_alias,
    aten.split, aten.unbind, aten.empty, aten.empty_strided, aten.lift_fresh,
}

_MATMUL = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_CONV = {aten.convolution, aten.convolution_backward}
#: ops whose FLOPs come from ``torch.utils.flop_counter`` and whose f32
#: operands take the AMP policy's class (``matmul_class``)
_DENSE = _MATMUL | _CONV

#: bilinear upsample (``align_corners=False``, no antialias), per output
#: element: two horizontal lerps and one vertical, each
#: ``w0·a + w1·b`` (2 multiplies, 1 add); the weights are per row and
#: column, not per element
UPSAMPLE_FLOPS = 9
#: its backward, per element of the incoming gradient (the forward's
#: output): four taps, each ``h·w·g`` (2 multiplies) added into the input
#: gradient (1 add)
UPSAMPLE_BWD_FLOPS = 12

# FLOPs per *output* element (reference: _ELEMENTWISE_1 / _TRANSCENDENTAL
# count 1 per element; a composite aten op counts the HLO ops it stands for)
_PER_OUT = {
    aten.add: 1, aten.sub: 1, aten.mul: 1, aten.div: 1, aten.maximum: 1,
    aten.minimum: 1, aten.abs: 1, aten.neg: 1, aten.remainder: 1,
    aten.atan2: 1, aten.floor: 1, aten.ceil: 1, aten.round: 1,
    aten.sign: 1, aten.clamp: 1, aten.rsub: 1, aten.reciprocal: 1,
    aten.exp: 1, aten.expm1: 1, aten.log: 1, aten.log1p: 1, aten.tanh: 1,
    aten.sqrt: 1, aten.rsqrt: 1, aten.pow: 1, aten.sigmoid: 1,
    aten.sin: 1, aten.cos: 1, aten.tan: 1, aten.erf: 1,
    aten.silu: 2,           # logistic + multiply (jax.nn.silu)
    aten.relu: 1,           # max(x, 0) (jax.nn.relu)
    aten.upsample_bilinear2d: UPSAMPLE_FLOPS,
    # elementwise backward ops, counted as the HLO ops of their formulas
    aten.sigmoid_backward: 3,      # g·(1 - y)·y
    aten.tanh_backward: 3,         # g·(1 - y²)
    aten.silu_backward: 6,         # g·s·(1 + x·(1 - s)), s = logistic(x)
}

# reductions: FLOPs = a·(input elements) + b·(output elements)
_REDUCE = {
    aten.sum: (1, 0), aten.amax: (1, 0), aten.amin: (1, 0),
    aten.max: (1, 0), aten.min: (1, 0),
    aten.mean: (1, 1),                 # reduce + divide
    aten._softmax: (5, 0),             # max, sub, exp, sum, div
    aten.logsumexp: (4, 2),            # max, sub, exp, sum; log, add
    aten._softmax_backward_data: (4, 0),   # y·(g - sum(g·y))
    aten._log_softmax_backward_data: (4, 0),   # g - exp(y)·sum(g)
}


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape_str(t: torch.Tensor) -> str:
    return f"{dtype_name(t.dtype)}[{','.join(map(str, t.shape))}]"


def _op_flops(packet, args, kwargs, out, inputs: list[torch.Tensor],
              outputs: list[torch.Tensor]) -> float:
    if packet in _DENSE:
        fn = flop_counter.flop_registry[packet]
        return float(fn(*args, **kwargs, out_val=out))
    if packet is aten.upsample_bilinear2d_backward:
        return float(UPSAMPLE_BWD_FLOPS * inputs[0].numel())
    if packet is aten._log_softmax:
        # max, sub, exp, sum and sub per element; one log per row
        x = inputs[0]
        return float(5 * x.numel() + x.numel() // max(x.shape[args[1]], 1))
    n_out = sum(t.numel() for t in outputs)
    if packet in _PER_OUT:
        return float(_PER_OUT[packet] * n_out)
    if packet in _REDUCE:
        a, b = _REDUCE[packet]
        n_in = inputs[0].numel() if inputs else 0
        return float(a * n_in + b * n_out)
    return 0.0


def _categorize(packet, flops: float, port: bool) -> str:
    if packet in _MATMUL:
        return "matmul"
    if packet in _CONV:
        return "conv"
    if port:
        return "custom"
    if not flops:
        return "zero-ai"
    if packet in _REDUCE or packet is aten._log_softmax:
        return "reduction"
    return "elementwise"


def _is_port_op(func) -> bool:
    return func.namespace == "repro_torch"


def _custom_flops(func, args) -> float:
    from repro_torch.kernels.fused.ops import op_flops
    return op_flops(func._opname, args)


def _custom_bytes(func, args) -> float | None:
    from repro_torch.kernels.fused.ops import op_bytes
    return op_bytes(func._opname, args)


def _written_args_bytes(func, args, kwargs) -> int:
    """Bytes of the operands an op mutates (its schema's ``Tensor(a!)``)."""
    out = 0
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        t = args[i] if i < len(args) else kwargs.get(a.name)
        out += sum(map(_nbytes, _tensors(t)))
    return out


def _flop_class(packet, inputs: list[torch.Tensor],
                outputs: list[torch.Tensor]) -> str:
    """Ceiling class from the *operand* dtype (the reference's MXU intake)."""
    src = [t for t in inputs if t.is_floating_point()] or inputs or outputs
    return dtype_class(dtype_name(src[0].dtype)) if src else "f32"


class _OpRecorder(TorchDispatchMode):
    """Records one merged :class:`KernelRecord` per launching aten op."""

    def __init__(self, matmul_class: str | None = None):
        super().__init__()
        self.matmul_class = matmul_class
        self.records: dict[tuple, KernelRecord] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _FREE or func.is_view:
            return out
        inputs, outputs = _tensors((args, kwargs)), _tensors(out)
        key = (str(func), tuple(_shape_str(t) for t in inputs),
               tuple(_shape_str(t) for t in outputs))
        rec = self.records.get(key)
        if rec is not None:
            rec.exec_count += 1
            return out
        port = _is_port_op(func)
        flops = (_custom_flops(func, args) if port else
                 _op_flops(packet, args, kwargs, out, inputs, outputs))
        cls = _flop_class(packet, inputs, outputs)
        if cls == "f32" and self.matmul_class and packet in _DENSE:
            cls = self.matmul_class
        nbytes = sum(map(_nbytes, inputs)) + sum(map(_nbytes, outputs))
        if port:
            model = _custom_bytes(func, args)
            nbytes = (int(model) if model is not None else
                      nbytes + _written_args_bytes(func, args, kwargs))
        self.records[key] = KernelRecord(
            name=f"{packet.__name__}.{len(self.records)}",
            opcode=packet.__name__,
            op_name=",".join(key[1]) + "->" + ",".join(key[2]),
            exec_count=1,
            flops_by_class={cls: flops} if flops else {},
            hbm_bytes=nbytes, vmem_bytes=nbytes,
            category=_categorize(packet, flops, port))
        return out


def to_meta(tree: Any) -> Any:
    """Meta-tensor stand-ins for every tensor leaf (nothing allocated)."""
    return tree_map(lambda t: (torch.empty_like(t, device="meta")
                               if isinstance(t, torch.Tensor) else t), tree)


def analyze_fn(fn: Callable, args: Sequence[Any],
               matmul_class: str | None = None) -> ModuleAnalysis:
    """Characterize ``fn(*args)`` op by op on meta tensors.

    ``args`` may hold tensors on any device; they are replaced by meta
    tensors of the same shape and dtype, so the walk allocates nothing and
    launches nothing.  ``matmul_class`` is the reference's policy override
    for f32-typed matmuls and convs (a no-op when the operands are bf16).
    """
    rec = _OpRecorder(matmul_class)
    meta_args = to_meta(tuple(args))
    with torch.no_grad(), rec:
        fn(*meta_args)
    return ModuleAnalysis(list(rec.records.values()), [])
