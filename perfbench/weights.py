"""Weights made from the run's seed, on the device, one call a leaf.

Each leaf is drawn from a generator of its own, seeded from the run's
seed and the leaf's path, so any one leaf can be made again alone: the
comparison remakes the initial weights leaf by leaf after the window,
where a second copy of the whole tree would not fit beside the
program's state.  The family's ``layout`` states each leaf's shape and
init rule; everything is float32, the dtype the weights are kept in.
"""

from __future__ import annotations

import hashlib
import math

import torch

Leaf = tuple[str, tuple[int, ...], str, float]


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed for one leaf of one run."""
    h = hashlib.sha256(f"perfbench-weights:{seed}:{path}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def make_leaf(leaf: Leaf, seed: int, device: torch.device | str
              ) -> torch.Tensor:
    """The leaf's float32 tensor: a normal draw times its std, ones,
    zeros, or Mamba-2's ``a_log`` (log A, A uniform in [1, 16]) and
    ``dt_bias`` (softplus⁻¹ of dt log-uniform in [1e-3, 1e-1])."""
    path, shape, init, std = leaf
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    if init == "normal":
        return torch.randn(shape, generator=gen, device=device).mul_(std)
    u = torch.rand(shape, generator=gen, device=device)
    if init == "a_log":
        return torch.log1p(15 * u)
    if init == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + u * (hi - lo))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r} of the leaf {path}")


class Weights:
    """The leaves of ``layout`` for ``seed`` on ``device``."""

    def __init__(self, layout: list[Leaf], seed: int,
                 device: torch.device | str):
        self.layout = {leaf[0]: leaf for leaf in layout}
        self.seed, self.device = seed, device

    def leaf(self, path: str) -> torch.Tensor:
        return make_leaf(self.layout[path], self.seed, self.device)

    def all(self) -> dict[str, torch.Tensor]:
        return {path: self.leaf(path) for path in self.layout}

    def shapes(self) -> dict[str, tuple[int, ...]]:
        return {path: leaf[1] for path, leaf in self.layout.items()}

    def count(self) -> int:
        return sum(math.prod(s) for s in self.shapes().values())
