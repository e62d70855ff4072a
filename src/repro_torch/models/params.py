"""Parameter specification utilities (port of ``repro.models.params``).

A model is described by a nested tree of :class:`P` specs (shape + logical
axis names + init rule): dicts, and lists where the reference's tree has
lists (DeepCAM's ``stages``).  Parameters keep the reference's layouts:
``wq`` (D, H, hd), ``wk``/``wv`` (D, K, hd), ``wo`` (H, hd, D),
layer-stacked leaves with a leading ``n_layers`` axis, HWIO conv kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"       # normal | zeros | ones | small_normal
    scale: float | None = None  # None → 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map_specs(fn: Callable[[P], Any], specs: Any) -> Any:
    """``fn`` over every spec, keeping the tree's structure: a dict's keys
    in sorted order (``jax.tree.flatten``'s), a list's items in index
    order."""
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, list):
        return [tree_map_specs(fn, v) for v in specs]
    return {k: tree_map_specs(fn, specs[k]) for k in sorted(specs)}


def leaves(specs: Any, prefix: str = "") -> list[tuple[str, P]]:
    """(path, spec) pairs in the order the reference's ``jax.tree.flatten``
    visits the tree (dict keys sorted, list items by index; a list item's
    path segment is its index)."""
    if isinstance(specs, P):
        return [(prefix, specs)]
    keys = range(len(specs)) if isinstance(specs, list) else sorted(specs)
    out = []
    for k in keys:
        out.extend(leaves(specs[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def count(specs: Any) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(specs))


def stack_layers(spec_fn: Callable[[], Any], n: int) -> Any:
    """Prepend a ``layers`` axis to every param in a layer spec."""
    return tree_map_specs(
        lambda p: P((n, *p.shape), ("layers", *p.axes), p.init, p.scale),
        spec_fn())


def unstack_layers(tree: Any) -> list[Any]:
    """The per-layer trees of a layer-stacked tree (the port's counterpart
    of the reference's ``lax.scan`` slices): every leaf unbound once along
    its leading axis, so each layer's leaves are views into the stack.

    Unbinding, not indexing layer by layer: the backward of ``unbind`` is
    one stack of the per-layer gradients, where each index's backward
    would write a zero-padded gradient of the whole stack and add it to
    the others — O(L²) bytes over L layers."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


def init(specs: Any, generator: torch.Generator | None,
         dtype: torch.dtype = torch.float32,
         device: str | torch.device = "cpu") -> Any:
    """Tensors for a spec tree, by the reference's rules: zeros, ones, or a
    float32 normal draw times 1/sqrt(fan-in) (0.02 for ``small_normal``),
    cast to ``dtype``.  Leaves are drawn from ``generator`` in
    :func:`leaves` order, and lists stay lists.  On the ``meta`` device
    nothing is drawn or allocated (the analytical path); ``generator`` may
    then be None.
    """
    device = torch.device(device)

    def one(p: P) -> torch.Tensor:
        if device.type == "meta":
            return torch.empty(p.shape, dtype=dtype, device=device)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        fan_in = math.prod(p.shape[:-1]) if len(p.shape) > 1 else 1
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
        if p.init == "small_normal":
            scale = 0.02
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)      # in place: one full-size buffer

    # draws in ``leaves`` order: tree_map_specs visits the same order
    return tree_map_specs(one, specs)


def _port_state_types() -> dict[str, type]:
    from repro_torch.distributed.amp import DynLossScale
    from repro_torch.models.hybrid import HybridState
    from repro_torch.models.ssm import SSMState
    from repro_torch.models.transformer import DecodeState
    from repro_torch.train.optim import AdafactorState, AdamWState
    from repro_torch.train.step import TrainState
    return {"TrainState": TrainState, "AdamWState": AdamWState,
            "AdafactorState": AdafactorState, "DynLossScale": DynLossScale,
            "DecodeState": DecodeState, "SSMState": SSMState,
            "HybridState": HybridState}


def from_jax_numpy(tree: Any, device: str | torch.device = "cpu") -> Any:
    """The reference's parameter tree — or a whole train or decode state —
    given as numpy arrays, as tensors.

    A train state is the reference's ``TrainState`` / ``AdamWState`` /
    ``AdafactorState`` / ``DynLossScale`` named tuples (params, AdamW
    ``mu`` / ``nu`` / ``count`` or Adafactor ``vr`` / ``vc`` / ``v`` /
    ``count``, loss ``scale`` / ``good_steps``, ``step``), a decode state
    its ``DecodeState`` / ``SSMState`` / ``HybridState``, after
    ``jax.tree.map(np.asarray, ...)``; each becomes the port's type of the
    same name.  ``torch.from_numpy`` cannot read ``ml_dtypes.bfloat16``;
    bf16 crosses as float32 (exact) and is cast back.
    """
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_jax_numpy(v, device) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        name = type(tree).__name__
        types = _port_state_types()
        if name not in types:
            raise TypeError(f"no port type for the named tuple {name!r}; "
                            f"known: {sorted(types)}")
        return types[name](*(from_jax_numpy(v, device) for v in tree))
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: arrays exported by JAX are read-only
    return torch.from_numpy(np.array(arr, copy=True)).to(device)
