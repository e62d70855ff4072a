"""Train-step factory: loss → grads → (scaled, accumulated) → optimizer
(port of ``repro.train.step``).

One step is the unit the paper profiles; :func:`make_phases` also exposes
its fwd / bwd / optimizer phases separately for the phase-wise roofline
(Figs 3-7).  Features, as in the reference:

* microbatch gradient accumulation (``run.microbatches``) with fp32
  accumulators (the param dtype under O2);
* dynamic loss scaling under O2 with overflow-skip semantics;
* the AdamW update; ``run.fusion = "static"`` threads through every
  phase (fused norms, SwiGLU epilogue and embedding backward in fwd/bwd,
  the fused AdamW leaf update in opt).

Differences from the reference, all for eager PyTorch:

* the step updates the parameters and both moments **in place** (the
  returned state holds the same tensors; count, loss scale and step are
  new ones), so a full-width step holds no second copy of them;
* on overflow under O2 the update is skipped by one host read of the
  finite flag (the reference selects old values with ``where``);
* gradients come from ``torch.autograd.grad`` under
  ``torch.enable_grad()``, so the step and the bwd phase also run inside
  the profiler's ``no_grad`` timing loop and the op walk.

On a mesh (params, optimizer state and batch DTensors,
``repro_torch.distributed.sharding``) the same step runs SPMD: each
gradient is brought to its parameter's placements (the data-parallel
all-reduce, or FSDP's reduce-scatter, that XLA inserts for the
reference), the optimizer updates each leaf's local shard, plain tensors
the code makes count as replicated, and microbatch ``i`` takes rows
``i, i + m, i + 2m, ...`` of the batch (a slice of each rank's own batch
shard, so splitting moves nothing; the loss and the summed gradient are
the same as with contiguous microbatches).  The microbatch loop is a
:func:`repro_torch.core.op_analysis.trips` loop: a walk with
``fold_loops`` walks one microbatch and counts it ``m`` times.  In a
walk on meta tensors the O2 finite flag cannot be read; the walk counts
the update.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import RunConfig
from repro_torch.core.op_analysis import once, trips
from repro_torch.distributed import amp
from repro_torch.distributed.sharding import is_dtensor, plain_as_replicated
from repro_torch.models.api import Model
from repro_torch.train import optim


class TrainState(NamedTuple):
    params: Any
    opt: Any
    loss_scale: amp.DynLossScale
    step: torch.Tensor         # () int32


def init_state(model: Model, run: RunConfig,
               generator: torch.Generator | None,
               device: str | torch.device = "cpu") -> TrainState:
    """Random params (drawn from ``generator`` on ``device``; meta tensors,
    drawing nothing, on ``meta``), zero optimizer state, the initial loss
    scale and step 0."""
    from repro_torch.models.params import init
    params = init(model.spec, generator, run.param_dtype, device)
    return TrainState(
        params=params,
        opt=optim.optimizer_init(params, run),
        loss_scale=amp.DynLossScale.init(device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def state_specs(model: Model, run: RunConfig, mesh: Any,
                state_like: TrainState | None = None) -> TrainState:
    """The :data:`~repro_torch.distributed.sharding.Spec` tree of a train
    state on ``mesh`` (a DeviceMesh or ``{axis: size}``): the params by
    the logical rules, the optimizer state from them, the loss scale and
    step replicated (the reference's dry-run state shardings)."""
    from repro_torch.distributed import sharding as shd
    like = state_like if state_like is not None else init_state(
        model, run, None, "meta")
    pspec = shd.param_shardings(model.spec, mesh, run)
    rep = shd.replicated(mesh)
    return TrainState(
        params=pspec, opt=shd.opt_state_shardings(like.opt, pspec, mesh),
        loss_scale=type(like.loss_scale)(*[rep for _ in like.loss_scale]),
        step=rep)


def value_and_grad(loss_fn: Callable, params: Any, *args
                   ) -> tuple[tuple[torch.Tensor, Any], Any]:
    """((loss, aux), grads) of ``loss_fn(params, *args) -> (loss, aux)``
    with respect to every tensor leaf of ``params`` (grads in each leaf's
    dtype, zeros for a leaf the loss does not use)."""
    flat, spec = tree_flatten(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in flat]
        loss, aux = loss_fn(tree_unflatten(leaves, spec), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like_param(g, p)
             for p, g in zip(flat, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tree_unflatten(grads, spec)


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (a pending
    partial sum reduced, a replicated one cut to the parameter's
    shard)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatch(batch: dict, m: int, i: int) -> dict:
    """Microbatch ``i`` of ``m``: rows ``[i·B/m, (i+1)·B/m)``, or rows
    ``i, i + m, ...`` of a DTensor batch (the module docstring)."""
    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            out[k] = v.reshape(v.shape[0] // m, m, *v.shape[1:])[:, i]
        else:
            out[k] = v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
    return out


def make_train_step(model: Model, run: RunConfig, lr: float = 3e-4
                    ) -> Callable[[TrainState, dict],
                                  tuple[TrainState, dict]]:
    use_scaling = run.amp == "O2"          # bf16 master weights need guarding

    def loss_of(params, mb, scale):
        loss, metrics = model.loss_fn(params, mb, run)
        if use_scaling:
            loss = amp.scale_loss(loss, scale)
        return loss, metrics

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        with plain_as_replicated():
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: dict
                    ) -> tuple[TrainState, dict]:
        m = run.microbatches
        if m > 1:
            # O2 accumulates in the storage dtype (bf16), as the reference
            acc_dt = run.param_dtype if run.amp == "O2" else torch.float32
            g_acc = _map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                         state.params)
            for i in trips(m):
                (_, metrics), grads = value_and_grad(
                    loss_of, state.params, _microbatch(batch, m, i),
                    state.loss_scale)
                if i == 0:
                    with once():
                        metric_acc = {k: torch.zeros_like(v)
                                      for k, v in metrics.items()}
                g_acc = _map2(lambda a, g: a + g.to(acc_dt), g_acc, grads)
                metric_acc = {k: metric_acc[k] + v
                              for k, v in metrics.items()}
            grads = _map(lambda g: g / m, g_acc)
            metrics = {k: v / m for k, v in metric_acc.items()}
        else:
            (_, metrics), grads = value_and_grad(
                loss_of, state.params, batch, state.loss_scale)

        if use_scaling:
            grads, new_scale, finite = amp.unscale_and_update(
                grads, state.loss_scale)
        else:
            new_scale = state.loss_scale
            finite = torch.ones((), dtype=torch.bool,
                                device=state.step.device)

        # overflow → skip the update (keep params/opt), shrink the scale;
        # the flag is read on the host only when loss scaling can raise it
        if not use_scaling or finite.device.type == "meta" or _read(finite):
            new_params, new_opt = optim.optimizer_update(
                grads, state.opt, state.params, run, lr=lr, inplace=True)
        else:
            new_params, new_opt = state.params, state.opt
        metrics = dict(metrics)
        metrics["grads_finite"] = finite.float()
        metrics["grad_norm"] = torch.sqrt(sum(
            torch.sum(g.float() ** 2) for g in tree_flatten(grads)[0]))
        return TrainState(new_params, new_opt, new_scale,
                          state.step + 1), metrics

    return train_step


def _read(flag: torch.Tensor) -> bool:
    return bool(flag.full_tensor() if is_dtensor(flag) else flag)


def _map(fn: Callable, tree: Any) -> Any:
    flat, spec = tree_flatten(tree)
    return tree_unflatten([fn(t) for t in flat], spec)


def _map2(fn: Callable, a: Any, b: Any) -> Any:
    fa, spec = tree_flatten(a)
    return tree_unflatten([fn(x, y) for x, y in
                           zip(fa, tree_flatten(b)[0])], spec)


# --------------------------------------------------------------------------
# Phase-split functions (paper Figs 3-7: fwd / bwd / optimizer separately)
# --------------------------------------------------------------------------

def make_phases(model: Model, run: RunConfig, lr: float = 3e-4
                ) -> dict[str, Callable]:
    """fwd / bwd / opt as separate callables for phase profiling.  ``opt``
    updates its params and optimizer state in place."""

    def fwd(params, batch):
        return model.loss_fn(params, batch, run)[0]

    def bwd(params, batch):
        return value_and_grad(lambda p, b: (fwd(p, b), {}), params, batch)[1]

    def opt(params, grads, opt_state):
        return optim.optimizer_update(grads, opt_state, params, run, lr=lr,
                                      inplace=True)

    return {"fwd": fwd, "bwd": bwd, "opt": opt}
