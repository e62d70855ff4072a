"""Automatic mixed precision (port of ``repro.distributed.amp``).

The AMP levels are carried by :class:`RunConfig` (``param_dtype`` /
``compute_dtype``): O0 fp32; O1 bf16 compute with fp32 params and
statistics; O2 bf16 params and optimizer state too.  This module adds
dynamic loss scaling, which guards O2's bf16 master weights: the scale
doubles after ``growth_interval`` finite steps in a row, halves on a
non-finite gradient, and the caller skips that step's update.  The
state lives on the device, so the scale is updated without a host sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map


class DynLossScale(NamedTuple):
    scale: torch.Tensor          # () float32
    good_steps: torch.Tensor     # () int32, consecutive finite steps

    @classmethod
    def init(cls, initial: float = 2.0 ** 15,
             device: str | torch.device = "cpu") -> "DynLossScale":
        return cls(scale=torch.tensor(initial, dtype=torch.float32,
                                      device=device),
                   good_steps=torch.zeros((), dtype=torch.int32,
                                          device=device))


def scale_loss(loss: torch.Tensor, s: DynLossScale) -> torch.Tensor:
    return loss * s.scale.to(loss.dtype)


def unscale_and_update(grads: Any, s: DynLossScale,
                       growth_interval: int = 2000
                       ) -> tuple[Any, DynLossScale, torch.Tensor]:
    """Unscale grads (to fp32); detect overflow; adjust the scale.

    Returns (unscaled grads, new state, grads_finite as a () bool
    tensor).  On overflow the caller must skip the optimizer update (see
    ``train.step``).
    """
    inv = 1.0 / s.scale
    grads = tree_map(lambda g: g.float() * inv, grads)
    finite = torch.ones((), dtype=torch.bool, device=s.scale.device)
    for g in tree_flatten(grads)[0]:
        finite = finite & torch.all(torch.isfinite(g))
    grown = s.good_steps + 1 >= growth_interval
    new_scale = torch.where(finite, torch.where(grown, s.scale * 2.0, s.scale),
                            s.scale * 0.5)
    new_scale = torch.clamp(new_scale, 1.0, 2.0 ** 24)
    new_steps = torch.where(finite & ~grown, s.good_steps + 1,
                            torch.zeros_like(s.good_steps))
    return grads, DynLossScale(new_scale, new_steps), finite

