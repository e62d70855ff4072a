"""Fused AdamW update (port of ``repro.kernels.fused.adamw``).

One pass over every leaf: g, m, v and p are read once and p′, m′, v′
written once, every intermediate in registers.  The math follows the
reference expression for expression in fp32; the bias corrections
``bc = (1 - b1^t, 1 - b2^t)`` come as a (2,) fp32 tensor on the device, so
a step needs no host sync.  Hyperparameters are plain floats.

The reference launches one ``pallas_call`` per leaf inside ``jit``, where a
launch has no Python behind it.  Eager PyTorch pays its host cost at every
launch, so here one launch of the kernel in ``csrc/fused.cu`` updates many
leaves: :func:`fused_adamw_multi` takes lists of leaves, groups them by
their (g, m, v, p) dtypes, and launches the kernel once per group (once
per :data:`CAPACITY` leaves of it), with a table of segments that
:func:`plan` lays out.  :func:`fused_adamw` is the one-leaf case.

Both are functional like the reference: they return new tensors.  With
``inplace=True`` they write p′, m′, v′ over p, m, v instead — the train
step uses that to avoid holding a second copy of the weights and both
moments (at glm4-9b width that copy would be 24.7 GB of fp32).

On CUDA tensors they launch the kernel (or raise); on CPU tensors they
run the plain version :func:`adamw_ref` leaf by leaf.
"""

from __future__ import annotations

import array
import operator
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.fused import common

#: FLOPs per element: the two moments (3 + 4), the corrected step (5) and
#: the decayed write (4)
FLOPS_PER_ELEMENT = 16

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0

#: leaves one launch holds (``kAdamSegs``): the table is the kernel's
#: parameter, at most 32,764 B
CAPACITY = 464
#: elements of the kernel's vector (16 B of f32, 8 B of bf16)
VEC = 4
#: the mode bit of a leaf read in vectors (``kAdamVec``); bits 0-1 hold
#: its scalar head
VEC_MODE = 4

_T = torch.Tensor
_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")


def adamw_ref(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              p: torch.Tensor, bc: torch.Tensor, *, lr: float, b1: float,
              b2: float, eps: float, weight_decay: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the reference's ``adamw_update`` leaf math in fp32,
    each result cast back to its leaf's dtype."""
    bc1, bc2 = bc[0], bc[1]
    gf = g.float()
    m2 = b1 * m.float() + (1 - b1) * gf
    v2 = b2 * v.float() + (1 - b2) * gf * gf
    step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    pf = p.float()
    newp = pf - lr * (step + weight_decay * pf)
    return newp.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)


# --------------------------------------------------------------------------
# The segment table (pure: integers in, integers out)
# --------------------------------------------------------------------------

def vector_head(addrs: Sequence[int], itemsizes: Sequence[int]) -> int | None:
    """Scalar elements before every one of a leaf's operands (at byte
    addresses ``addrs``, elements of ``itemsizes`` bytes) sits on a
    :data:`VEC`-element boundary; ``None`` when their offsets from one
    differ, and the kernel reads the leaf element by element."""
    offs = {(a // s) % VEC for a, s in zip(addrs, itemsizes)}
    return (-offs.pop()) % VEC if len(offs) == 1 else None


class Launch(NamedTuple):
    """One launch of a dtype group: ``rows`` holds, per leaf, the int64
    fields of ``fused_adamw_multi``'s table — the seven pointers (g, m,
    v, p, p′, m′, v′), the length and the mode.  The C entry cuts the
    leaves into the chunks its blocks take."""
    leaves: range
    rows: list[int]


def plan(ptrs: Sequence[Sequence[int]], numels: Sequence[int],
         itemsizes: Sequence[int], capacity: int = CAPACITY
         ) -> list[Launch]:
    """The launches that update one dtype group's leaves, in leaf order:
    ``ptrs[i]`` the seven addresses of leaf ``i`` (g, m, v, p, p′, m′,
    v′), ``numels[i] > 0`` its length, ``itemsizes`` the (g, m, v, p)
    element sizes; at most ``capacity`` leaves a launch.  A leaf whose
    seven pointers share their offset from a vector boundary is read in
    vectors after its scalar head; any other leaf element by element."""
    sizes = (*itemsizes, itemsizes[3], itemsizes[1], itemsizes[2])
    out = []
    for start in range(0, len(numels), capacity):
        leaves = range(start, min(start + capacity, len(numels)))
        rows = []
        for i in leaves:
            n, a = numels[i], ptrs[i]
            head = 0       # all 16-byte aligned: on a boundary in any dtype
            if (a[0] | a[1] | a[2] | a[3] | a[4] | a[5] | a[6]) & 15:
                head = vector_head(a, sizes)
            rows += a
            rows += (n, 0 if head is None else VEC_MODE | head)
        out.append(Launch(leaves, rows))
    return out


def lookup_shape(n: int) -> tuple[int]:
    """The shape at which a launch over ``n > 0`` elements reads its tuned
    config: ``n``'s size class, the power of two at or below it.  A
    group's element count moves with the leaves the dispatch table routes
    to the kernel, and the table is measured after the kernel is tuned; a
    small leaf that flips route leaves the class where it was (only half
    the group can move it), and the winner of a streaming launch follows
    the order of its work, not each leaf."""
    return (1 << (n.bit_length() - 1),)


def groups(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
           vs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor]
           ) -> dict[tuple[torch.dtype, ...], list[int]]:
    """Leaf indices by their (g, m, v, p) dtypes, groups in order of
    first appearance and leaves in order: the kernel instance each group
    launches."""
    out: dict[tuple[torch.dtype, ...], list[int]] = {}
    keys = zip(*(map(_DTYPE, ts) for ts in (gs, ms, vs, ps)))
    for i, key in enumerate(keys):
        out.setdefault(key, []).append(i)
    return out


def tune_points(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor]
                ) -> list[tuple[str, tuple[int], str]]:
    """(kernel, shape, dtype) of each tuned-config lookup that
    :func:`fused_adamw_multi` makes on these leaves: one per dtype group
    with elements, at :func:`lookup_shape` of the group's element count
    and p's dtype."""
    out = []
    for dtypes, idx in groups(gs, ms, vs, ps).items():
        n = sum(ps[i].numel() for i in idx)
        if n:
            out.append(("fused_adamw", lookup_shape(n),
                        str(dtypes[3]).removeprefix("torch.")))
    return out


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def fused_adamw_multi(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor],
                      bc: torch.Tensor, *, lr: float = 3e-4, b1: float = 0.9,
                      b2: float = 0.95, eps: float = 1e-8,
                      weight_decay: float = 0.1, inplace: bool = False,
                      config: kc.KernelConfig | None = None
                      ) -> tuple[list[torch.Tensor], list[torch.Tensor],
                                 list[torch.Tensor]]:
    """Every leaf's AdamW update → (ps′, ms′, vs′), lists in leaf
    order.

    Leaf ``i`` is g, m, v, p ``= gs[i], ms[i], vs[i], ps[i]``: one shape,
    each f32 or bf16, contiguous.  ``bc``: (2,) fp32, the bias
    corrections ``1 - beta^count``.  ``inplace=True`` writes the results
    over p, m, v and returns them.  On the card one launch per (g, m, v,
    p) dtype combination (one per :data:`CAPACITY` leaves of it), each
    with the tune store's config at :func:`lookup_shape` of the group's
    element count.
    """
    global LAUNCHES
    n_leaves = len(ps)
    if not len(gs) == len(ms) == len(vs) == n_leaves:
        raise ValueError(f"AdamW lists differ in length: g {len(gs)}, m "
                         f"{len(ms)}, v {len(vs)}, p {n_leaves}")
    # one C call per tensor and property (``map``), no Python loop body:
    # the host cost of a leaf is most of what a launch over small leaves
    # costs
    shapes = list(map(_SHAPE, ps))
    for ts in (gs, ms, vs):
        if list(map(_SHAPE, ts)) != shapes:
            i = next(i for i, (t, p) in enumerate(zip(ts, ps))
                     if t.shape != p.shape)
            raise ValueError(f"AdamW leaf shapes differ: g "
                             f"{tuple(gs[i].shape)}, m {tuple(ms[i].shape)}, "
                             f"v {tuple(vs[i].shape)}, p {tuple(ps[i].shape)}")
    if tuple(bc.shape) != (2,) or bc.dtype != torch.float32:
        raise ValueError(f"bc must be a (2,) float32 tensor, got "
                         f"{tuple(bc.shape)}/{bc.dtype}")
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if bc.device.type == "cpu" and all(
            t.device.type == "cpu" for leaf in (gs, ms, vs, ps) for t in leaf):
        outs = [adamw_ref(*leaf, bc, **hyper)
                for leaf in zip(gs, ms, vs, ps)]
        if inplace:
            for dsts, leaf in zip(zip(ps, ms, vs), outs):
                for dst, src in zip(dsts, leaf):
                    dst.copy_(src)
            return list(ps), list(ms), list(vs)
        return ([o[0] for o in outs], [o[1] for o in outs],
                [o[2] for o in outs])
    dev = bc.device
    for ts in (gs, ms, vs, ps):
        if dev.type != "cuda" or set(map(_T.get_device, ts)) - {dev.index} \
                or not all(map(_T.is_contiguous, ts)):
            raise ValueError(f"expected contiguous CUDA tensors on the "
                             f"device of bc ({dev})")
    if inplace:
        po, mo, vo = ps, ms, vs
    else:
        po, mo, vo = ([torch.empty_like(t) for t in ts] for ts in (ps, ms, vs))
    numels = list(map(_T.numel, ps))
    addrs = [list(map(_T.data_ptr, ts)) for ts in (gs, ms, vs, ps)]
    outs = [addrs[3], addrs[1], addrs[2]] if inplace else [
        list(map(_T.data_ptr, ts)) for ts in (po, mo, vo)]
    ptrs = list(zip(*addrs, outs[0], outs[1], outs[2]))
    lib = None
    for dtypes, idx in groups(gs, ms, vs, ps).items():
        idx = [i for i in idx if numels[i]]
        if not idx:
            continue
        p0 = ps[idx[0]]
        group = [numels[i] for i in idx]
        cfg = kc.for_launch("fused_adamw", config, p0,
                            lookup_shape(sum(group)))
        threads = int(cfg.get("threads"))
        most = build.sm_count(p0) * int(cfg.get("blocks_per_sm"))
        codes = [common.code(dt) for dt in dtypes]
        lib = lib or build.load("fused")
        for launch in plan([ptrs[i] for i in idx], group,
                           [dt.itemsize for dt in dtypes]):
            rows = array.array("q", launch.rows)
            err = lib.fused_adamw_multi(
                rows.buffer_info()[0], len(launch.leaves), bc.data_ptr(),
                float(lr), float(b1), float(b2), float(1 - b1),
                float(1 - b2), float(eps), float(weight_decay), *codes,
                most, threads, build.stream_of(p0))
            build.check(lib, err, "fused_adamw_multi")
            LAUNCHES += 1
    return list(po), list(mo), list(vo)


def fused_adamw(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                p: torch.Tensor, bc: torch.Tensor, *, lr: float = 3e-4,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.1, inplace: bool = False,
                config: kc.KernelConfig | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's AdamW update in one pass → (p′, m′, v′): the one-leaf
    case of :func:`fused_adamw_multi` (one launch of the same kernel).

    g, m, v, p: one shape, each f32 or bf16.  ``bc``: (2,) fp32, the bias
    corrections ``1 - beta^count``.  ``inplace=True`` writes the results
    over p, m, v and returns them.
    """
    (p2,), (m2,), (v2,) = fused_adamw_multi(
        [g], [m], [v], [p], bc, lr=lr, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, inplace=inplace, config=config)
    return p2, m2, v2


def hbm_bytes(n: int, itemsize: int = 4) -> float:
    """Fused traffic of one leaf: g, m, v, p in and p′, m′, v′ out, one
    pass each, plus the 8-byte ``bc`` operand (which the reference's
    ``7 * n * itemsize`` leaves out)."""
    return float(7 * n * itemsize + 8)


def flops(n: int) -> float:
    return float(FLOPS_PER_ELEMENT * n)
