"""AdamW (port of ``repro.train.optim``).

Optimizer state mirrors the parameter tree.  The optimizer step is the
paper's "optimizer phase" (Fig 7): unfused, a chain of elementwise
kernels per leaf at zero or low arithmetic intensity; under
``fusion="static"`` one fused kernel per eligible leaf
(``repro_torch.kernels.fused.adamw``).

:func:`adamw_update` is functional by default, like the reference.  With
``inplace=True`` it writes the new parameters and moments over the old
ones (the unfused chain through ``copy_``, the fused kernel directly):
the train step and the opt phase use that, so a step holds no second
copy of the weights and both moments.

The reference blocks very large leaves over their leading axis
(``_blocked``, a ``lax.map``) to shrink XLA's fp32 temporaries.  A loop
over leaves in PyTorch frees each leaf's temporaries before the next
leaf, and the fused kernel has none, so that blocking is not ported.
Adafactor is not ported yet: ``RunConfig`` refuses it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

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

    ``run`` with fusion enabled sends each eligible leaf through the fused
    kernel; others keep the plain chain (same math).  ``inplace=True``
    updates ``params``, ``state.mu`` and ``state.nu`` in place and returns
    them (the count is always a new tensor).
    """
    c = state.count + 1
    bc = bias_corrections(c, b1, b2)
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    fops = None
    if run is not None:
        from repro_torch.kernels.fused import ops as _fops
        if _fops.fusion_enabled(run):
            fops = _fops

    def leaf(g, m, v, p):
        if fops is not None and fops.use_adamw(run, g, m, v, p):
            return fops.adamw_leaf(g, m, v, p, bc, inplace=inplace, **hyper)
        out = adamw_ref(g, m, v, p, bc, **hyper)
        if not inplace:
            return out
        for dst, src in zip((p, m, v), out):
            dst.copy_(src)
        return p, m, v

    flat_p, spec = tree_flatten(params)
    flat_g, flat_m, flat_v = (_flat_like(t, spec, name) for t, name in (
        (grads, "grads"), (state.mu, "mu"), (state.nu, "nu")))
    with torch.no_grad():
        out = [leaf(g, m, v, p)
               for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p)]
    newp = tree_unflatten([o[0] for o in out], spec)
    newm = tree_unflatten([o[1] for o in out], spec)
    newv = tree_unflatten([o[2] for o in out], spec)
    return newp, AdamWState(newm, newv, c)


def _flat_like(tree: Any, spec, name: str) -> list[torch.Tensor]:
    """``tree``'s leaves, which must line up with the params' (same keys
    in the same order)."""
    flat, got = tree_flatten(tree)
    if got != spec:
        raise ValueError(f"{name} tree does not match the params tree")
    return flat


def optimizer_init(params: Any, run: RunConfig) -> AdamWState:
    return adamw_init(params, run)


def optimizer_update(grads: Any, state: AdamWState, params: Any,
                     run: RunConfig, lr: float = 3e-4,
                     inplace: bool = False) -> tuple[Any, AdamWState]:
    return adamw_update(grads, state, params, lr=lr, run=run,
                        inplace=inplace)
