"""AdamW (port of ``repro.train.optim``).

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
(``_blocked``, a ``lax.map``) to shrink XLA's fp32 temporaries.  The
plain chain here runs leaf by leaf, freeing each leaf's temporaries
before the next, and the fused kernel has none, so that blocking is not
ported.  Adafactor is not ported yet: ``RunConfig`` refuses it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_structure, tree_unflatten

from repro_torch.configs.base import RunConfig
from repro_torch.kernels.fused.adamw import adamw_ref


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
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

    ``run`` with fusion enabled routes each leaf as ``use_adamw`` says
    (eligibility; under ``auto`` also the dispatch table) and updates the
    routed leaves together in one ``adamw_group`` call; the others keep
    the plain chain (same math).  ``inplace=True`` updates ``params``,
    ``state.mu`` and ``state.nu`` in place and returns those trees (the
    count is always a new tensor).
    """
    c = state.count + 1
    bc = bias_corrections(c, b1, b2)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    flat_p, flat_g, flat_m, flat_v = _leaves_like(params, grads, state.mu,
                                                  state.nu)
    leaves = list(zip(flat_g, flat_m, flat_v, flat_p))
    fused = []
    if run is not None:
        from repro_torch.kernels.fused import ops as fops
        if fops.fusion_enabled(run):
            fused = [i for i, leaf in enumerate(leaves)
                     if fops.use_adamw(run, *leaf)]
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
    spec = tree_structure(params)
    newp, newm, newv = (tree_unflatten([o[k] for o in out], spec)
                        for k in range(3))
    return newp, AdamWState(newm, newv, c)


def _plain(g, m, v, p, bc, *, inplace: bool, **hyper):
    """One leaf through the plain chain → (p′, m′, v′)."""
    out = adamw_ref(g, m, v, p, bc, **hyper)
    if not inplace:
        return out
    for dst, src in zip((p, m, v), out):
        dst.copy_(src)
    return p, m, v


#: the trees that line up with the params, as errors name them
_TREES = ("grads", "mu", "nu")


def _leaves_like(params: Any, grads: Any, mu: Any, nu: Any
                 ) -> list[list[torch.Tensor]]:
    """[params, grads, mu, nu leaves], the last three trees lining up
    with the params (the same containers with the same keys), in
    ``tree_flatten``'s order: dict values in insertion order, list and
    tuple items in order.  The params trees are dicts and lists of
    tensors (``models/params.py``); any other node raises.  One walk
    over the four trees: ``tree_flatten`` builds a spec node per
    container and costs several times this on hundreds of leaves."""
    out: list[list[torch.Tensor]] = [[], [], [], []]
    _walk(out, params, grads, mu, nu)
    return out


def _walk(out, p, g, m, v) -> None:
    """Append the leaves under p, g, m, v to ``out`` (a module function,
    not a closure: a recursive closure is a reference cycle that would
    keep ``out``, and every gradient in it, alive until the collector
    runs)."""
    tp = type(p)
    if tp is dict:
        keys = p.keys()
        if not (type(g) is type(m) is type(v) is dict and g.keys() == keys
                and m.keys() == keys and v.keys() == keys):
            raise _mismatch(p, g, m, v)
        for k, x in p.items():
            _walk(out, x, g[k], m[k], v[k])
    elif tp is list or tp is tuple:
        if not (type(g) is type(m) is type(v) is tp
                and len(g) == len(m) == len(v) == len(p)):
            raise _mismatch(p, g, m, v)
        for leaf in zip(p, g, m, v):
            _walk(out, *leaf)
    elif isinstance(p, torch.Tensor):
        if not (isinstance(g, torch.Tensor) and isinstance(m, torch.Tensor)
                and isinstance(v, torch.Tensor)):
            raise _mismatch(p, g, m, v)
        for dst, t in zip(out, (p, g, m, v)):
            dst.append(t)
    else:
        raise ValueError(f"adamw_update takes trees of dicts, lists and "
                         f"tuples of tensors; the params hold a "
                         f"{type(p).__name__}")


def _mismatch(p, *others) -> ValueError:
    """The error for a node of grads, mu or nu unlike the params' node
    ``p``, naming the first such tree."""
    k = next(k for k, o in enumerate(others)
             if type(o) is not type(p) or (
                 isinstance(p, (dict, list, tuple)) and (
                     len(o) != len(p) or (isinstance(p, dict)
                                          and o.keys() != p.keys()))))
    return ValueError(f"{_TREES[k]} tree does not match the params tree")


def optimizer_init(params: Any, run: RunConfig) -> AdamWState:
    return adamw_init(params, run)


def optimizer_update(grads: Any, state: AdamWState, params: Any,
                     run: RunConfig, lr: float = 3e-4,
                     inplace: bool = False) -> tuple[Any, AdamWState]:
    return adamw_update(grads, state, params, lr=lr, run=run,
                        inplace=inplace)
