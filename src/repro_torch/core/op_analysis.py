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

**Per device, with collectives.**  When the arguments hold DTensors (a
run on a mesh), the walk records what *this rank* runs: DTensor's
dispatch is let through (the recorder declines DTensor types, as
``CommDebugMode`` does), so the mode sees the local ops at their local
shapes and the functional collectives DTensor issues to redistribute.
Two kinds of op are not the rank's work and are dropped: the pass
DTensor's sharding propagation makes over FakeTensors at the *global*
shapes (counting it would double the FLOPs, the copy at the global
size), and the bookkeeping DTensor computes on host tensors (shard
offsets); a mesh walk keeps only ops on meta tensors.  Each collective
is a :class:`CollectiveRecord` under the reference's conventions
(``hlo_analysis._walk``): opcodes ``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all`` (``collective-broadcast`` for a
broadcast); the payload is the result for an all-reduce, the n× output
of an all-gather, the larger (input) side of a reduce-scatter or an
all-to-all; wire bytes are ``2(n-1)/n`` × payload for an all-reduce and
``(n-1)/n`` × for the others, with n at least 2; ``cross_pod`` when the
group's ranks fall in more than one block of ``devices_per_pod``.  Each
is also a zero-AI kernel record (category ``collective``) with its
operand and result bytes.

:func:`trips` folds a loop whose trips are identical (gradient
accumulation's microbatches): under a walk that asks for it, the body
runs once and every op in it counts ``n`` times, as the reference counts
a while loop's body by its trip count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import weakref
from collections import defaultdict
from typing import Any, Callable, Iterator, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor
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
    #: the walk's high-water mark of live (local) tensor bytes: the
    #: arguments, then every op's outputs until they are freed
    peak_bytes: int = 0

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


# functional collectives (``torch.ops._c10d_functional``, and DTensor's
# own all-to-all) → the reference's opcode; anything else of the
# namespace (waits, autograd wrappers) launches nothing
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")

# wire-traffic multiplier (ring algorithms): bytes on the slowest link ≈
# mult × payload (the reference's ``_COLL_MULT``)
_COLL_MULT = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-broadcast": lambda n: 1.0,
}


def _group_ranks(args: Sequence) -> list[int]:
    """The global ranks of a functional collective's group (its last
    string argument names it)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next(a for a in reversed(args) if isinstance(a, str))
    return dist.get_process_group_ranks(_resolve_process_group(name))


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


def _dtensor_type() -> type | None:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod.DTensor if mod is not None else None


class _OpRecorder(TorchDispatchMode):
    """Records one merged :class:`KernelRecord` per launching aten op, and
    one :class:`CollectiveRecord` per functional collective."""

    def __init__(self, matmul_class: str | None = None,
                 devices_per_pod: int | None = None, mesh: bool = False,
                 fold_loops: bool = False):
        super().__init__()
        self.matmul_class = matmul_class
        self.devices_per_pod = devices_per_pod
        self.mesh = mesh
        self.fold_loops = fold_loops
        self.multiplier = 1
        self.outer: list[int] = []       # multipliers outside folded loops
        self.records: dict[tuple, KernelRecord] = {}
        self.collectives: dict[tuple, CollectiveRecord] = {}
        self.live_bytes = self.peak_bytes = 0
        self._storages: dict[int, weakref.ref] = {}

    def track(self, tensors: Sequence[torch.Tensor]) -> None:
        """Count the meta storages of ``tensors`` live until they are
        freed (a view shares its base's storage); keep the peak."""
        for t in tensors:
            if isinstance(t, FakeTensor) or t.device.type != "meta":
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = weakref.ref(
                st, functools.partial(self._freed, key, n))
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int, n: int, _ref) -> None:
        if self._storages.pop(key, None) is not None:
            self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.mesh and any(t is not torch.Tensor
                             and not issubclass(t, FakeTensor)
                             for t in types):
            # DTensor (and a collective's async wrapper) dispatch
            # themselves: the mode sees the local ops they run
            return NotImplemented
        out = func(*args, **kwargs)
        outputs = _tensors(out)
        self.track(outputs)
        packet = func.overloadpacket
        if packet in _FREE or func.is_view:
            return out
        inputs = _tensors((args, kwargs))
        if self.mesh and any(isinstance(t, FakeTensor) or
                             t.device.type != "meta"
                             for t in (*inputs, *outputs)):
            return out            # sharding propagation, or bookkeeping
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if packet.__name__ in _COLLECTIVE_OPS:
                self._collective(func, args, inputs, outputs)
            return out
        key = (str(func), tuple(_shape_str(t) for t in inputs),
               tuple(_shape_str(t) for t in outputs))
        rec = self.records.get(key)
        if rec is not None:
            rec.exec_count += self.multiplier
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
            exec_count=self.multiplier,
            flops_by_class={cls: flops} if flops else {},
            hbm_bytes=nbytes, vmem_bytes=nbytes,
            category=_categorize(packet, flops, port))
        return out

    def _collective(self, func, args, inputs, outputs) -> None:
        opcode = _COLLECTIVE_OPS[func.overloadpacket.__name__]
        ranks = _group_ranks(args)
        n = len(ranks)
        out_b = sum(map(_nbytes, outputs))
        in_b = sum(map(_nbytes, inputs))
        payload = out_b
        if opcode in ("reduce-scatter", "all-to-all"):
            payload = max(out_b, in_b)       # keyed on the larger side
        dpp = self.devices_per_pod
        cross = bool(dpp) and len({r // dpp for r in ranks}) > 1
        key = (str(func), tuple(_shape_str(t) for t in inputs),
               tuple(_shape_str(t) for t in outputs), tuple(ranks))
        rec = self.collectives.get(key)
        if rec is not None:
            rec.exec_count += self.multiplier
            self.records[key].exec_count += self.multiplier
            return
        name = f"{opcode}.{len(self.collectives)}"
        self.collectives[key] = CollectiveRecord(
            name=name, opcode=opcode, exec_count=self.multiplier,
            payload_bytes=payload,
            wire_bytes=payload * _COLL_MULT[opcode](max(n, 2)),
            group_size=n, cross_pod=cross)
        # the collective is also a zero-AI kernel moving its operand and
        # its result through device memory
        self.records[key] = KernelRecord(
            name=name, opcode=opcode,
            op_name=",".join(key[1]) + "->" + ",".join(key[2]),
            exec_count=self.multiplier, flops_by_class={},
            hbm_bytes=in_b + out_b, vmem_bytes=in_b + out_b,
            category="collective")


_ACTIVE: list[_OpRecorder] = []


@contextlib.contextmanager
def _recording(rec: _OpRecorder) -> Iterator[_OpRecorder]:
    _ACTIVE.append(rec)
    try:
        with rec:
            yield rec
    finally:
        _ACTIVE.pop()


def trips(n: int) -> Iterator[int]:
    """``range(n)`` for a loop whose trips run the same ops at the same
    shapes; under a walk with ``fold_loops`` one trip, every op of which
    counts ``n`` times."""
    rec = _ACTIVE[-1] if _ACTIVE else None
    if rec is None or not rec.fold_loops or n <= 1:
        yield from range(n)
        return
    prev = rec.multiplier
    rec.outer.append(prev)
    rec.multiplier = prev * n
    try:
        yield 0
    finally:
        rec.multiplier = rec.outer.pop()


@contextlib.contextmanager
def once() -> Iterator[None]:
    """Inside a folded :func:`trips` loop: work that the loop does on one
    trip only (its first), counted once."""
    rec = _ACTIVE[-1] if _ACTIVE else None
    if rec is None or not rec.outer:
        yield
        return
    prev = rec.multiplier
    rec.multiplier = rec.outer[-1]
    try:
        yield
    finally:
        rec.multiplier = prev


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    dt = _dtensor_type()
    if dt is not None and isinstance(t, dt):
        if t._local_tensor.device.type == "meta":
            return t
        local = torch.empty_like(t._local_tensor, device="meta")
        return dt.from_local(local, t.device_mesh, t.placements,
                             run_check=False, shape=t.shape,
                             stride=t.stride())
    return torch.empty_like(t, device="meta")


def to_meta(tree: Any) -> Any:
    """Meta-tensor stand-ins for every tensor leaf (nothing allocated); a
    DTensor keeps its mesh and placements over a meta local tensor."""
    return tree_map(lambda t: (_meta_like(t) if isinstance(t, torch.Tensor)
                               else t), tree)


def has_dtensor(tree: Any) -> bool:
    dt = _dtensor_type()
    return dt is not None and any(isinstance(t, dt)
                                  for t in tree_flatten(tree)[0])


def analyze_fn(fn: Callable, args: Sequence[Any],
               matmul_class: str | None = None,
               devices_per_pod: int | None = None,
               fold_loops: bool = False) -> ModuleAnalysis:
    """Characterize ``fn(*args)`` op by op on meta tensors.

    ``args`` may hold tensors on any device; they are replaced by meta
    tensors of the same shape and dtype, so the walk allocates nothing and
    launches nothing.  ``matmul_class`` is the reference's policy override
    for f32-typed matmuls and convs (a no-op when the operands are bf16).
    DTensor arguments make it a per-device walk (the module docstring);
    ``devices_per_pod`` then splits its collectives into ``cross_pod`` or
    not (None: none is).  ``fold_loops`` folds :func:`trips` loops.
    """
    mesh = has_dtensor(args)
    rec = _OpRecorder(matmul_class, devices_per_pod, mesh=mesh,
                      fold_loops=fold_loops)
    meta_args = to_meta(tuple(args))
    rec.track([_local(t) for t in _tensors(meta_args)])
    with torch.no_grad(), _replicating(mesh), _recording(rec):
        fn(*meta_args)
    return ModuleAnalysis(list(rec.records.values()),
                          list(rec.collectives.values()), rec.peak_bytes)


def _local(t: torch.Tensor) -> torch.Tensor:
    dt = _dtensor_type()
    return t._local_tensor if dt is not None and isinstance(t, dt) else t


def _replicating(mesh: bool):
    """On a mesh, plain tensors the code makes (positions, masks) meet
    DTensors as replicated ones."""
    if not mesh:
        return contextlib.nullcontext()
    from repro_torch.distributed.sharding import plain_as_replicated
    return plain_as_replicated()
