"""AdamW and Adafactor (port of ``repro.train.optim``).

Optimizer state mirrors the parameter tree.  The optimizer step is the
paper's "optimizer phase" (Fig 7): unfused, a chain of elementwise
kernels per leaf at zero or low arithmetic intensity; under
``fusion="static"`` one fused multi-tensor kernel over every eligible
leaf (``repro_torch.kernels.fused.adamw``, one launch per dtype group).

:func:`adamw_update` is functional by default, like the reference.  With
``inplace=True`` it writes the new parameters and moments over the old
ones (the unfused chain through ``copy_``, the fused kernel directly):
the train step and the opt phase use that, so a step holds no second
copy of the weights and both moments.

The reference blocks very large leaves over their leading axis
(``_blocked``, a ``lax.map``) to shrink XLA's fp32 temporaries.  For
AdamW the result is the same function (its update is elementwise): the
plain chain here runs leaf by leaf, freeing each leaf's temporaries
before the next, and the fused kernel has none, so that blocking is not
ported there.  Adafactor's update is not elementwise — its second-moment
factors are means over the last two axes and its update clipping an RMS
over the whole leaf — so the blocking changes what it computes (the
clipping RMS becomes one a layer slice) and is ported with it
(:func:`_blocked`, the same :data:`_BLOCK_BYTES`).

Adafactor (:func:`adafactor_update`) factors the second moment of each
leaf of rank ≥ 2 over the **last two axes as laid out** (a stacked
``wq`` (L, D, H, hd) keeps vr (L, D, H) and vc (L, D, hd)), keeps an
unfactored one for rank-1 leaves, has no first moment and no weight
decay, and clips each update to RMS 1.  It has no fused kernel, nor does
the reference.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_structure, tree_unflatten

from repro_torch.configs.base import RunConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.fused.adamw import adamw_ref


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor        # () int32


class AdafactorState(NamedTuple):
    vr: Any        # row second moment: shape[:-1] ((1,) for rank < 2)
    vc: Any        # column second moment: shape[:-2] + shape[-1:]
    v: Any         # the unfactored second moment of a rank-1 leaf
    count: torch.Tensor        # () int32


def _moment_dtype(run: RunConfig) -> torch.dtype:
    return torch.float32 if run.amp in ("O0", "O1") else torch.bfloat16


def adamw_init(params: Any, run: RunConfig) -> AdamWState:
    """Zero moments (fp32 under O0/O1, bf16 under O2) and a zero count, on
    the params' device (meta params give meta state)."""
    mdt = _moment_dtype(run)
    flat, spec = tree_flatten(params)

    def zeros():
        return tree_unflatten([torch.zeros(p.shape, dtype=mdt,
                                           device=p.device) for p in flat],
                              spec)

    dev = flat[0].device if flat else torch.device("cpu")
    return AdamWState(mu=zeros(), nu=zeros(),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def bias_corrections(count: torch.Tensor, b1: float, b2: float
                     ) -> torch.Tensor:
    """(2,) fp32 ``(1 - b1^count, 1 - b2^count)`` on count's device."""
    cf = count.float()
    return torch.stack([1.0 - b1 ** cf, 1.0 - b2 ** cf])


def adamw_update(grads: Any, state: AdamWState, params: Any,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 run: RunConfig | None = None, inplace: bool = False
                 ) -> tuple[Any, AdamWState]:
    """One AdamW step → (new params, new state).

    ``run`` with fusion enabled routes the leaves as ``adamw_routes``
    says (eligibility; under ``auto`` also the dispatch table, one verdict
    a dtype group) and updates the routed leaves together in one
    ``adamw_group`` call; the others keep
    the plain chain (same math).  ``inplace=True`` updates ``params``,
    ``state.mu`` and ``state.nu`` in place and returns those trees (the
    count is always a new tensor).

    DTensor leaves (a run on a mesh): the update is elementwise, so each
    rank updates its local shards — the kernel, or the plain chain, on
    the local tensors, the moments sharded as their parameter — after
    each gradient is brought to its parameter's placements.
    """
    c = state.count + 1
    bc = bias_corrections(c, b1, b2)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    flat_p, flat_g, flat_m, flat_v = _leaves_like(params, grads, state.mu,
                                                  state.nu)
    mesh_params = flat_p if flat_p and is_dtensor(flat_p[0]) else None
    if mesh_params is not None:
        flat_g = [g.redistribute(p.device_mesh, p.placements).to_local()
                  for g, p in zip(flat_g, flat_p)]
        flat_p, flat_m, flat_v = ([t.to_local() for t in ts]
                                  for ts in (flat_p, flat_m, flat_v))
        bc = bc.full_tensor() if is_dtensor(bc) else bc
    leaves = list(zip(flat_g, flat_m, flat_v, flat_p))
    fused = []
    if run is not None:
        from repro_torch.kernels.fused import ops as fops
        if fops.fusion_enabled(run):
            fused = fops.adamw_routes(run, leaves)
    with torch.no_grad():
        done = {}
        if fused:
            outs = fops.adamw_group(
                *([leaves[i][k] for i in fused] for k in range(4)), bc,
                inplace=inplace, **hyper)
            done = dict(zip(fused, zip(*outs)))
        out = [done[i] if i in done else
               _plain(*leaf, bc, inplace=inplace, **hyper)
               for i, leaf in enumerate(leaves)]
    if inplace:
        return params, AdamWState(state.mu, state.nu, c)
    if mesh_params is not None:
        out = [tuple(_wrap_like(t, p) for t in o)
               for o, p in zip(out, mesh_params)]
    spec = tree_structure(params)
    newp, newm, newv = (tree_unflatten([o[k] for o in out], spec)
                        for k in range(3))
    return newp, AdamWState(newm, newv, c)


def _wrap_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The local tensor ``t`` as a DTensor placed as the parameter ``p``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def _plain(g, m, v, p, bc, *, inplace: bool, **hyper):
    """One leaf through the plain chain → (p′, m′, v′)."""
    out = adamw_ref(g, m, v, p, bc, **hyper)
    if not inplace:
        return out
    for dst, src in zip((p, m, v), out):
        dst.copy_(src)
    return p, m, v


#: the trees that line up with the params in an AdamW step, as errors
#: name them
_TREES = ("grads", "mu", "nu")


def _leaves_like(params: Any, *trees: Any, names: tuple = _TREES
                 ) -> list[list[torch.Tensor]]:
    """[params leaves, then each tree's], every tree lining up with the
    params (the same containers with the same keys) and named in errors
    by ``names``, in ``tree_flatten``'s order: dict values in insertion
    order, list and tuple items in order.  The params trees are dicts
    and lists of tensors (``models/params.py``); any other node raises.
    One walk over all the trees: ``tree_flatten`` builds a spec node per
    container and costs several times this on hundreds of leaves."""
    out: list[list[torch.Tensor]] = [[] for _ in range(1 + len(trees))]
    _walk(out, names, params, *trees)
    return out


def _walk(out, names, p, *others) -> None:
    """Append the leaves under p and ``others`` to ``out`` (a module
    function, not a closure: a recursive closure is a reference cycle
    that would keep ``out``, and every gradient in it, alive until the
    collector runs)."""
    tp = type(p)
    if tp is dict:
        keys = p.keys()
        if not all(type(o) is dict and o.keys() == keys for o in others):
            raise _mismatch(names, p, others)
        for k, x in p.items():
            _walk(out, names, x, *[o[k] for o in others])
    elif tp is list or tp is tuple:
        if not all(type(o) is tp and len(o) == len(p) for o in others):
            raise _mismatch(names, p, others)
        for leaf in zip(p, *others):
            _walk(out, names, *leaf)
    elif isinstance(p, torch.Tensor):
        if not all(isinstance(o, torch.Tensor) for o in others):
            raise _mismatch(names, p, others)
        for dst, t in zip(out, (p, *others)):
            dst.append(t)
    else:
        raise ValueError(f"the optimizer takes trees of dicts, lists and "
                         f"tuples of tensors; the params hold a "
                         f"{type(p).__name__}")


def _mismatch(names, p, others) -> ValueError:
    """The error for a node of another tree unlike the params' node
    ``p``, naming the first such tree."""
    k = next(k for k, o in enumerate(others)
             if type(o) is not type(p) or (
                 isinstance(p, (dict, list, tuple)) and (
                     len(o) != len(p) or (isinstance(p, dict)
                                          and o.keys() != p.keys()))))
    return ValueError(f"{names[k]} tree does not match the params tree")


# --------------------------------------------------------------------------
# Adafactor
# --------------------------------------------------------------------------

#: a leaf of more bytes than this, whose dim 0 is a stacked-layers axis
#: (2 to 128), is updated one layer slice at a time (the reference's
#: ``_BLOCK_BYTES``, a module constant here too, so that a test can lower
#: it in both packages)
_BLOCK_BYTES = 2 ** 28


def _blocked(upd: Callable, args: tuple, dst: tuple | None = None):
    """``upd(*args)``, or, for a leaf past :data:`_BLOCK_BYTES` with a
    layers-like dim 0 that every argument shares, ``upd`` on each slice
    of dim 0 (the reference's ``lax.map``): a per-slice update keeps
    per-slice statistics.  With ``dst`` the results are written over
    ``dst`` (slice by slice when blocked) and None is returned; without,
    the results (stacked when blocked)."""
    p = args[-1]
    if (p.dim() >= 2 and 1 < p.shape[0] <= 128
            and p.numel() * p.element_size() > _BLOCK_BYTES
            and all(a.dim() >= 1 and a.shape[0] == p.shape[0]
                    for a in args)):
        outs = []
        for i in range(p.shape[0]):
            new = upd(*(a[i] for a in args))
            if dst is None:
                outs.append(new)
            else:
                for d, n in zip(dst, new):
                    d[i].copy_(n)
        return None if dst is not None else tuple(torch.stack(o)
                                                  for o in zip(*outs))
    new = upd(*args)
    if dst is None:
        return new
    for d, n in zip(dst, new):
        d.copy_(n)
    return None


def adafactor_init(params: Any, run: RunConfig) -> AdafactorState:
    """Zero factored moments (fp32 under O0/O1, bf16 under O2) and a zero
    count, on the params' device: a leaf of rank ≥ 2 takes vr and vc and
    a (1,) v, a rank-1 leaf a (1,) vr and vc and a v of its shape."""
    mdt = _moment_dtype(run)
    flat, spec = tree_flatten(params)

    def zeros(shape_of):
        return tree_unflatten([torch.zeros(shape_of(p), dtype=mdt,
                                           device=p.device) for p in flat],
                              spec)

    dev = flat[0].device if flat else torch.device("cpu")
    return AdafactorState(
        vr=zeros(lambda p: p.shape[:-1] if p.dim() >= 2 else (1,)),
        vc=zeros(lambda p: p.shape[:-2] + p.shape[-1:] if p.dim() >= 2
                 else (1,)),
        v=zeros(lambda p: (1,) if p.dim() >= 2 else p.shape),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def _mean(x: torch.Tensor, dim: int | None = None,
          keepdim: bool = False) -> torch.Tensor:
    """``torch.mean``; of a DTensor, a sum whose partial result is
    all-reduced, then divided (older torch cannot move a mean's ``avg``
    partial onto a sharded operand)."""
    if not is_dtensor(x):
        return torch.mean(x) if dim is None else torch.mean(x, dim,
                                                            keepdim=keepdim)
    from torch.distributed.tensor import Replicate
    s = torch.sum(x) if dim is None else torch.sum(x, dim, keepdim=keepdim)
    want = [Replicate() if p.is_partial() else p for p in s.placements]
    if want != list(s.placements):
        s = s.redistribute(s.device_mesh, want)
    return s / (x.numel() if dim is None else x.shape[dim])


def _clip(step: torch.Tensor, clip: float) -> torch.Tensor:
    """Update clipping (Adafactor §6): divide by max(1, RMS / clip)."""
    rms = torch.sqrt(_mean(step * step))
    return step / torch.clamp_min(rms / clip, 1.0)


def _factored(g, vr, vc, p, *, b2, lr, eps, clip):
    gf = g.float()
    g2 = gf * gf + eps
    vr2 = b2 * vr.float() + (1 - b2) * _mean(g2, -1)
    vc2 = b2 * vc.float() + (1 - b2) * _mean(g2, -2)
    denom = _mean(vr2, -1, keepdim=True)
    vhat = (vr2[..., None] * vc2[..., None, :]
            / torch.clamp_min(denom[..., None], eps))
    step = _clip(gf / torch.sqrt(vhat + eps), clip)
    newp = p.float() - lr * step
    return newp.to(p.dtype), vr2.to(vr.dtype), vc2.to(vc.dtype)


def _unfactored(g, v, p, *, b2, lr, eps, clip):
    gf = g.float()
    g2 = gf * gf + eps
    v2 = b2 * v.float() + (1 - b2) * g2
    step = _clip(gf / torch.sqrt(v2 + eps), clip)
    newp = p.float() - lr * step
    return newp.to(p.dtype), v2.to(v.dtype)


def adafactor_update(grads: Any, state: AdafactorState, params: Any,
                     lr: float = 1e-3, decay: float = 0.8,
                     eps: float = 1e-30, clip: float = 1.0,
                     inplace: bool = False) -> tuple[Any, AdafactorState]:
    """One Adafactor step → (new params, new state): ``b2 = 1 −
    count^−decay``, ``eps`` added to g² (and to the factored estimate),
    no first moment, no weight decay.  ``inplace=True`` writes the new
    params, vr, vc and v over the old ones (one leaf, or one layer slice
    of a blocked leaf, at a time) and returns those trees (the count is
    always a new tensor)."""
    c = state.count + 1
    b2 = 1.0 - c.float() ** -decay
    hyper = dict(b2=b2, lr=lr, eps=eps, clip=clip)
    flat_p, flat_g, flat_r, flat_c, flat_v = _leaves_like(
        params, grads, state.vr, state.vc, state.v,
        names=("grads", "vr", "vc", "v"))
    factored = lambda *a: _factored(*a, **hyper)
    unfactored = lambda *a: _unfactored(*a, **hyper)
    out = []
    with torch.no_grad():
        for g, vr, vc, v, p in zip(flat_g, flat_r, flat_c, flat_v, flat_p):
            if p.dim() >= 2:
                fn, args, dst = factored, (g, vr, vc, p), (p, vr, vc)
            else:
                fn, args, dst = unfactored, (g, v, p), (p, v)
            new = _blocked(fn, args, dst if inplace else None)
            if not inplace:
                out.append((*new, v) if p.dim() >= 2
                           else (new[0], vr, vc, new[1]))
    if inplace:
        return params, AdafactorState(state.vr, state.vc, state.v, c)
    spec = tree_structure(params)
    newp, vr2, vc2, v2 = (tree_unflatten([o[k] for o in out], spec)
                          for k in range(4))
    return newp, AdafactorState(vr2, vc2, v2, c)


def optimizer_init(params: Any, run: RunConfig):
    """The state of ``run.optimizer``: AdamW's or Adafactor's."""
    if run.optimizer == "adafactor":
        return adafactor_init(params, run)
    return adamw_init(params, run)


def optimizer_update(grads: Any, state, params: Any, run: RunConfig,
                     lr: float = 3e-4, inplace: bool = False):
    """One step of ``run.optimizer`` (AdamW routes by ``run.fusion``;
    Adafactor has no kernel)."""
    if run.optimizer == "adafactor":
        return adafactor_update(grads, state, params, lr=lr,
                                inplace=inplace)
    return adamw_update(grads, state, params, lr=lr, run=run,
                        inplace=inplace)
