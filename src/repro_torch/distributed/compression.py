"""Gradient compression for the slow (cross-pod) all-reduce leg (port of
``repro.distributed.compression``).

Compressing the cross-pod exchange 4x (fp32 → int8) moves the
collective roofline term down in proportion.  The scheme:

1. the reduce inside a pod stays at full precision (the fast link),
2. the cross-pod exchange quantizes to int8 with one fp32 scale a tensor
   (symmetric, no stochastic rounding),
3. **error feedback**: the quantization residual is added to the next
   step's gradient, so the compression error stays O(1) over training
   rather than O(T).

``compress`` / ``decompress`` are plain tensor functions;
``psum_compressed`` is the cross-pod mean all-reduce as an int8
all-gather plus a local fp32 sum, through torch's functional collectives
(``_c10d_functional``), which the op walk counts: an all-gather's wire
bytes are ``(n-1)/n`` of its ``n·N``-byte output, ``(n-1)·N``, against
an fp32 ring all-reduce's ``2(n-1)/n · 4N`` — ``n/8`` of it, a quarter
on a two-pod axis (the reference's docstring counts ``(n-1)/n · N``,
one rank's share).

Nothing calls it from the train step: ``RunConfig.grad_compression`` is
read by nothing, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass
class ErrorFeedback:
    residual: Any      # the gradient tree's structure, fp32 leaves

    @classmethod
    def init(cls, grads_like: Any) -> "ErrorFeedback":
        return cls(tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads_like))


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 → (int8 payload, fp32 scale): symmetric linear quantization
    (round half to even, as ``jnp.round``)."""
    amax = g.abs().max()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(int8, scale, new residual) of ``g`` plus the carried residual."""
    corrected = g.to(torch.float32) + residual
    q, scale = compress(corrected)
    return q, scale, corrected - decompress(q, scale)


def pod_group(group: Any):
    """A process group as it is, or a ``DeviceMesh``'s ``"pod"``
    dimension's group."""
    from torch.distributed.device_mesh import DeviceMesh
    return group.get_group("pod") if isinstance(group, DeviceMesh) else group


def _all_gather(t: torch.Tensor, group: Any) -> torch.Tensor:
    """(n, *t.shape): ``t`` of every rank of ``group``, stacked, by the
    functional all-gather (its dtype on the wire)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    ops = torch.ops._c10d_functional
    out = ops.all_gather_into_tensor(t.reshape(-1).contiguous(), n,
                                     group.group_name)
    return ops.wait_tensor(out).view(n, *t.shape)


def psum_compressed(g: torch.Tensor, residual: torch.Tensor, group: Any
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-pod mean all-reduce with an int8 wire format and error
    feedback, on every rank of ``group`` (a process group, or a
    ``DeviceMesh`` whose ``"pod"`` dimension is taken).  Returns (the
    mean, the new residual)."""
    group = pod_group(group)
    q, scale, new_residual = compress_with_feedback(g, residual)
    qs = _all_gather(q, group)                      # (n, ...) int8 on wire
    scales = _all_gather(scale.reshape(1), group)   # (n, 1), negligible
    n = qs.shape[0]
    summed = torch.sum(qs.to(torch.float32)
                       * scales.reshape((n,) + (1,) * q.ndim), dim=0)
    return summed / n, new_residual


def tree_psum_compressed(grads: Any, ef: ErrorFeedback, group: Any
                         ) -> tuple[Any, ErrorFeedback]:
    flat_g, spec = tree_flatten(grads)
    flat_r = tree_flatten(ef.residual)[0]
    out_g, out_r = [], []
    for g, r in zip(flat_g, flat_r):
        s, nr = psum_compressed(g, r, group)
        out_g.append(s.to(g.dtype))
        out_r.append(nr)
    return (tree_unflatten(out_g, spec),
            ErrorFeedback(tree_unflatten(out_r, spec)))
