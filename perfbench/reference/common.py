"""What the reference families share: the products in a stated
precision, RMSNorm, the token cross-entropy, AdamW, and the loop that
follows the first train steps and reads what the comparison needs.

The reference computes in float32 with TF32 off (:func:`exact_fp32`).
Its control (:class:`Products` with ``"fp8"``) rounds to float8 e4m3,
each tensor scaled by its own absolute maximum, every tensor that the
configurations keep in bfloat16: both operands and the result of every
product, and the activations the families pass through
:meth:`Products.act` (the residual stream, the norms' outputs, the
mixers' inner activations).  That is the step below the bfloat16
compute the configurations state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Callable

import torch
import torch.nn.functional as F

#: precisions of :class:`Products`: the reference's, the compute dtype
#: the configurations state (a witness, not a check: its forward values
#: rounded, and at ``bf16bwd`` the gradients through the same points
#: too) and the control's
PRECISIONS = ("fp32", "bf16", "bf16bwd", "fp8")

_E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    """x rounded to e4m3 on a per-tensor scale; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBf16(torch.autograd.Function):
    """x rounded to bfloat16; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBf16Both(torch.autograd.Function):
    """x rounded to bfloat16, and its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


_ROUND = {"fp8": _RoundFp8, "bf16": _RoundBf16, "bf16bwd": _RoundBf16Both}


class Products:
    """``torch.einsum`` of two float32 operands, and :meth:`act` for the
    activations held in the compute dtype; at ``"fp8"`` (``"bf16"``) the
    operands, the result and those activations are rounded to float8
    e4m3 (bfloat16)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; valid: "
                             f"{PRECISIONS}")
        self.precision = precision

    def __call__(self, eq: str, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
        return self.act(torch.einsum(eq, self.act(a), self.act(b)))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the compute precision holds it."""
        rnd = _ROUND.get(self.precision)
        return x if rnd is None else rnd.apply(x)


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """x / sqrt(mean(x²) + eps) · scale over the last axis."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean token cross-entropy over the first ``vocab`` logit columns
    (the rest pad the table)."""
    lg = logits[..., :vocab]
    return F.cross_entropy(lg.reshape(-1, vocab),
                           targets.reshape(-1).long())


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with decoupled weight decay on every leaf:
    m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g²,
    p ← p − lr·(m̂ / (√v̂ + eps) + wd·p), m̂ and v̂ bias-corrected."""

    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float

    @torch.no_grad()
    def step(self, t: int, p: torch.Tensor, g: torch.Tensor,
             m: torch.Tensor, v: torch.Tensor) -> None:
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        mhat = m / (1 - self.b1 ** t)
        vhat = v / (1 - self.b2 ** t)
        upd = mhat / (vhat.sqrt() + self.eps) + self.weight_decay * p
        p.sub_(self.lr * upd)


#: elements of a leaf whose values the readings keep (all of a smaller
#: leaf)
SAMPLE = 65536
#: leaves under this prefix are stacked over the layers (a leading
#: ``n_layers`` axis)
STACKED = "blocks/"
#: the key of a stacked leaf's top layer, sampled on its own: its
#: gradient passes through one layer's backward, not through all of them
TOP = "@top"


def sample_index(seed: int, path: str, numel: int, device) -> torch.Tensor:
    """The flat indices of a leaf's sampled elements, drawn from the
    run's seed and the leaf's path."""
    if numel <= SAMPLE:
        return torch.arange(numel, device=device)
    h = hashlib.sha256(f"perfbench-sample:{seed}:{path}".encode())
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(h.digest()[:8], "little") >> 1)
    return torch.randint(0, numel, (SAMPLE,), generator=gen, device=device)


def sample_plan(seed: int, leaves: dict[str, torch.Tensor]
                ) -> dict[str, dict[str, torch.Tensor]]:
    """Per leaf path, {sample key: flat indices}: the leaf's own sample
    under its path and, for a stacked leaf, its top layer's under
    ``path + TOP``."""
    plan = {}
    for path, t in leaves.items():
        keys = {path: sample_index(seed, path, t.numel(), t.device)}
        if path.startswith(STACKED) and t.dim() > 1 and t.shape[0] > 1:
            per = t.numel() // t.shape[0]
            keys[path + TOP] = sample_index(seed, path + TOP, per,
                                            t.device) + (t.shape[0] - 1) * per
        plan[path] = keys
    return plan


def sampled(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1)[idx].double().cpu()


def samples(t: torch.Tensor, keys: dict[str, torch.Tensor]
            ) -> dict[str, torch.Tensor]:
    """{sample key: the sampled values of ``t``} by one leaf's plan."""
    return {k: sampled(t, idx) for k, idx in keys.items()}


@dataclasses.dataclass
class Readings:
    """What a run of the first train steps gives the comparison: the loss
    of each step, by leaf path the first gradient's norm and the change
    over the steps' norm, and by sample key (:func:`sample_plan`) their
    sampled values."""

    losses: list[float]
    grad_norms: dict[str, float]
    change_norms: dict[str, float]
    grad_samples: dict[str, torch.Tensor]
    change_samples: dict[str, torch.Tensor]


def follow(loss_fn: Callable, params: dict[str, torch.Tensor],
           initial: Callable[[str], torch.Tensor], batches: list[dict],
           opt: AdamW, seed: int) -> Readings:
    """Train ``params`` (path → float32 leaf, changed in place) through
    one step per batch with ``loss_fn(params, batch)`` and ``opt``, and
    read the losses, the first gradients and, against ``initial(path)``
    (each leaf made again), the change of every leaf."""
    paths = list(params)
    plan = sample_plan(seed, params)
    for p in params.values():
        p.requires_grad_(True)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad_norms, grad_samples = [], {}, {}
    for t, batch in enumerate(batches, start=1):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in paths])
        losses.append(float(loss.detach()))
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(g.double()))
                          for k, g in zip(paths, grads)}
            for k, g in zip(paths, grads):
                grad_samples.update(samples(g, plan[k]))
        for k, g in zip(paths, grads):
            opt.step(t, params[k].data, g, m[k], v[k])
        del grads, loss
    del m, v
    change, change_samples = {}, {}
    with torch.no_grad():
        for k in paths:
            d = params[k].detach() - initial(k)
            change[k] = float(torch.linalg.vector_norm(d.double()))
            change_samples.update(samples(d, plan[k]))
    return Readings(losses, grad_norms, change, grad_samples,
                    change_samples)
