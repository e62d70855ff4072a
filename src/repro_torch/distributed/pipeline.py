"""GPipe pipeline parallelism over a group of stages (port of
``repro.distributed.pipeline``).

Layers are split into ``S`` contiguous stages, one a rank of the group
(the reference's ``pod`` mesh axis); microbatches stream through the
GPipe schedule: tick ``t`` runs microbatch ``t - stage`` on ``stage``,
and activations hop to the next stage each tick.  The hop is an
autograd function whose backward is the same exchange reversed (the
reference's ``ppermute``, whose transpose is the reversed permutation),
so a backward runs through the same schedule.  Bubble fraction
``(S-1)/(M+S-1)``.

Every stage runs every tick, as the reference's ``scan`` does, and
selects with ``where`` (stage 0 takes the fresh microbatch, the last
stage commits): every rank's graph then holds the same hops in the same
order, and its backward exchanges match its neighbours'.  Each rank
calls :func:`gpipe` and back-propagates from its own result (valid on
the last stage; the others' select nothing from their stage function).
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _exchange(t: torch.Tensor, group: Any, step: int) -> torch.Tensor:
    """Send ``t`` to the stage ``step`` ahead and return what the stage
    ``step`` behind sent (one stage: ``t`` itself)."""
    import torch.distributed as dist
    S = dist.get_world_size(group)
    if S == 1:
        return t.clone()
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % S)
    src = dist.get_global_rank(group, (r - step) % S)
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t.contiguous(), dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    """Each stage's tensor to the next stage; the gradient back."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _exchange(y, group, +1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -1), None


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          local_params: Any, x_mbs: torch.Tensor, group: Any
          ) -> torch.Tensor:
    """Run microbatches through the pipeline's stages.

    stage_fn: (local_params, x (b, s, d)) → (b, s, d)
    x_mbs: (M, b, s, d) microbatched hidden states (read on stage 0).
    group: the stages, one a rank (a process group, or a ``DeviceMesh``
    whose ``"pod"`` dimension is taken).
    Returns (M, b, s, d): the last stage's outputs on the last stage.
    """
    import torch.distributed as dist

    from repro_torch.distributed.compression import pod_group
    group = pod_group(group)
    S = dist.get_world_size(group)
    stage = dist.get_rank(group)
    M = x_mbs.shape[0]
    first = torch.tensor(stage == 0, device=x_mbs.device)
    outs = [torch.zeros_like(x_mbs[0]) for _ in range(M)]
    recv = torch.zeros_like(x_mbs[0])
    for t in range(M + S - 1):
        # stage 0 feeds fresh microbatches; the others take the
        # neighbour's output
        x_in = torch.where(first, x_mbs[min(t, M - 1)], recv)
        y = stage_fn(local_params, x_in)
        # the last stage commits its result for microbatch t-(S-1)
        i = min(max(t - (S - 1), 0), M - 1)
        commit = torch.tensor(stage == S - 1 and t >= S - 1,
                              device=x_mbs.device)
        outs[i] = torch.where(commit, y, outs[i])
        # hop to the next stage (the last stage's wraparound is ignored)
        recv = _Hop.apply(y, group)
    return torch.stack(outs)


def stage_slice(n_layers: int, group: Any) -> tuple[int, int]:
    """(this stage's first layer index, layers a stage)."""
    import torch.distributed as dist

    from repro_torch.distributed.compression import pod_group
    group = pod_group(group)
    per = n_layers // dist.get_world_size(group)
    return dist.get_rank(group) * per, per


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
