"""Model facade (port of ``repro.models.api``) for the dense, SSM, hybrid
and CNN (DeepCAM) families.

``build(cfg)`` returns a :class:`Model` whose ``loss_fn`` / ``forward_fn``
close over the config; ``batch_schema`` and ``synthetic_batch`` give the
input batch of one shape cell.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.models import deepcam as DC
from repro_torch.models import hybrid as HY
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
    if cfg.family == "hybrid":
        return _build_lm(cfg, HY)
    if cfg.family == "cnn":
        return _build_deepcam(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r}: the port has the dense, SSM and hybrid LMs "
        "and DeepCAM (ROADMAP queue 1)")


def _build_lm(cfg: ModelConfig, module) -> Model:
    """The reference's ``_build_dense`` / ``_build_ssm`` /
    ``_build_hybrid`` without their decode members (they come with
    serving): a token LM whose ``module`` has ``lm_spec`` and
    ``forward``."""

    def loss_fn(params, batch, run):
        logits = module.forward(params, batch["tokens"], cfg, run)
        return lm_loss(logits, batch["targets"], cfg.vocab_size)

    def forward_fn(params, batch, run):
        return module.forward(params, batch["tokens"], cfg, run)

    return Model(cfg, module.lm_spec(cfg), loss_fn, forward_fn)


def _build_deepcam(cfg: ModelConfig) -> Model:
    """The reference's ``_build_deepcam``: ``d_model`` is the stem width,
    and the loss runs the lowering that ``resolve_impl(run)`` picks
    (``fusion="auto"`` upgrades the default to ``fused``).  So does the
    forward, where the reference's always runs ``reference``: the logits
    then come from the same lowering as the loss."""

    def loss_fn(params, batch, run):
        loss = DC.deepcam_loss(params, batch["images"], batch["labels"], run,
                               impl=DC.resolve_impl(run))
        return loss, {"loss": loss}

    def forward_fn(params, batch, run):
        return DC.deepcam_forward(params, batch["images"], run,
                                  DC.resolve_impl(run))

    return Model(cfg, DC.deepcam_spec(cfg.d_model), loss_fn, forward_fn)


def batch_schema(cfg: ModelConfig, shape: ShapeSpec,
                 per_device_batch: int | None = None
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one train cell's input batch: token LMs,
    or DeepCAM's images (B, H, W, 16) f32 and labels (B, H, W) int32 at
    the paper's resolution (``IMAGE_HW``) for a stem width of 64 or more,
    ``SMOKE_HW`` below (``shape.seq_len`` is not read).  Prefill and
    decode cells come with serving (ROADMAP queue 1, decode and
    serving)."""
    B = per_device_batch if per_device_batch is not None else shape.global_batch
    if cfg.family == "cnn":
        from repro_torch.configs.deepcam import IMAGE_HW, SMOKE_HW
        hw = IMAGE_HW if cfg.d_model >= 64 else SMOKE_HW
        return {"images": ((B, *hw, DC.IN_CHANNELS), torch.float32),
                "labels": ((B, *hw), torch.int32)}
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind} cells come with serving "
                                  "(ROADMAP queue 1, decode and serving)")
    S = shape.seq_len
    return {"tokens": ((B, S), torch.int32),
            "targets": ((B, S), torch.int32)}


def synthetic_batch(cfg: ModelConfig, shape: ShapeSpec, batch: int,
                    generator: torch.Generator | None,
                    device: str | torch.device = "cpu") -> Batch:
    """Random batch with :func:`batch_schema`'s schema, drawn from
    ``generator``: tokens in ``[0, vocab)``; DeepCAM images normal × 0.02
    and labels in ``[0, 3)``.  Meta tensors, drawing nothing, when
    ``device`` is ``meta``."""
    out: Batch = {}
    for name, (shp, dt) in batch_schema(cfg, shape, batch).items():
        if torch.device(device).type == "meta":
            out[name] = torch.empty(shp, dtype=dt, device=device)
        elif name == "images":
            out[name] = torch.randn(shp, generator=generator, dtype=dt,
                                    device=device).mul_(0.02)
        else:
            high = DC.N_CLASSES if name == "labels" else max(cfg.vocab_size,
                                                              2)
            out[name] = torch.randint(0, high, shp, generator=generator,
                                      dtype=dt, device=device)
    return out
