"""Model facade (port of ``repro.models.api``) for the dense and SSM
families.

``build(cfg)`` returns a :class:`Model` whose ``loss_fn`` / ``forward_fn``
close over the config; ``batch_schema`` and ``synthetic_batch`` give the
input batch of one shape cell.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TR

Params = Any
Batch = dict[str, torch.Tensor]


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            vocab: int | None = None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Token cross-entropy in the reference's one-hot form
    (``logZ - sum(onehot * logits)``).

    ``vocab``: real vocab size — columns ≥ vocab are embedding-table
    padding (``ModelConfig.vocab_padded``) and are masked with -1e30.
    The dense and SSM families have no auxiliary loss, so the
    reference's ``0.01 * aux`` term is zero and left out.
    """
    V = logits.shape[-1]
    lg = logits.float()
    cols = torch.arange(V, device=logits.device)
    if vocab is not None and vocab < V:
        lg = torch.where(cols < vocab, lg, -1e30)
    logz = torch.logsumexp(lg, dim=-1)
    onehot = (targets[..., None] == cols).float()
    ll = torch.sum(onehot * lg, dim=-1)
    ce = torch.mean(logz - ll)
    return ce, {"loss": ce, "ce": ce}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    spec: Params
    loss_fn: Callable[[Params, Batch, RunConfig],
                      tuple[torch.Tensor, dict[str, torch.Tensor]]]
    forward_fn: Callable[[Params, Batch, RunConfig], torch.Tensor]


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return _build_lm(cfg, TR)
    if cfg.family == "ssm":
        return _build_lm(cfg, SM)
    raise NotImplementedError(
        f"family {cfg.family!r}: the port has the dense and SSM LMs "
        "(ROADMAP queue 1)")


def _build_lm(cfg: ModelConfig, module) -> Model:
    """The reference's ``_build_dense`` / ``_build_ssm``: a token LM whose
    ``module`` has ``lm_spec`` and ``forward``."""

    def loss_fn(params, batch, run):
        logits = module.forward(params, batch["tokens"], cfg, run)
        return lm_loss(logits, batch["targets"], cfg.vocab_size)

    def forward_fn(params, batch, run):
        return module.forward(params, batch["tokens"], cfg, run)

    return Model(cfg, module.lm_spec(cfg), loss_fn, forward_fn)


def batch_schema(cfg: ModelConfig, shape: ShapeSpec,
                 per_device_batch: int | None = None
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one train cell's input batch (token LMs);
    prefill and decode cells come with serving (ROADMAP queue 1
    item 12)."""
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind} cells come with serving "
                                  "(ROADMAP queue 1 item 12)")
    B = per_device_batch if per_device_batch is not None else shape.global_batch
    S = shape.seq_len
    return {"tokens": ((B, S), torch.int32),
            "targets": ((B, S), torch.int32)}


def synthetic_batch(cfg: ModelConfig, shape: ShapeSpec, batch: int,
                    generator: torch.Generator | None,
                    device: str | torch.device = "cpu") -> Batch:
    """Random token batch with :func:`batch_schema`'s schema (meta tensors,
    drawing nothing, when ``device`` is ``meta``)."""
    out: Batch = {}
    for name, (shp, dt) in batch_schema(cfg, shape, batch).items():
        if torch.device(device).type == "meta":
            out[name] = torch.empty(shp, dtype=dt, device=device)
        else:
            out[name] = torch.randint(0, max(cfg.vocab_size, 2), shp,
                                      generator=generator, dtype=dt,
                                      device=device)
    return out
