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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import RunConfig
from repro_torch.distributed import amp
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
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tree_unflatten(grads, spec)


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    return [{k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(m)]


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
        m = run.microbatches
        if m > 1:
            # O2 accumulates in the storage dtype (bf16), as the reference
            acc_dt = run.param_dtype if run.amp == "O2" else torch.float32
            g_acc = metric_acc = None
            for mb in _split_microbatches(batch, m):
                (_, metrics), grads = value_and_grad(
                    loss_of, state.params, mb, state.loss_scale)
                if g_acc is None:
                    g_acc = _map(lambda g: torch.zeros(
                        g.shape, dtype=acc_dt, device=g.device), grads)
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
        if not use_scaling or bool(finite):
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
