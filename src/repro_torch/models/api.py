"""Model facade (port of ``repro.models.api``): every family of the
reference — dense, MoE, VLM, audio / enc-dec, SSM, hybrid and CNN
(DeepCAM).

``build(cfg)`` returns a :class:`Model` whose members close over the
config:

* ``loss_fn(params, batch, run)`` → (loss, metrics)   [train step]
* ``forward_fn(params, batch, run)`` → logits          [prefill]
* ``decode_fn(params, batch, state, run)`` → (logits, new state) [decode]
* ``init_state_fn(batch, max_len, dtype, device)`` → an empty decode
  state (zeros; on ``meta``, the default, the shapes alone)

DeepCAM has no decode members.  ``batch_schema`` and ``synthetic_batch``
give the input batch of one shape cell (train, prefill or decode), and
``decode_state_specs`` the decode state of a decode cell.  A VLM's batch
carries its patch embeddings (``prefix``), an enc-dec's its encoder
frames (``frames``) or, to decode, the encoder's output (``memory``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.models import deepcam as DC
from repro_torch.models import hybrid as HY
from repro_torch.models import multimodal as MM
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TR

Params = Any
Batch = dict[str, torch.Tensor]


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            vocab: int | None = None, aux: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Token cross-entropy in the reference's one-hot form
    (``logZ - sum(onehot * logits)``), plus ``0.01 * aux``.

    ``vocab``: real vocab size — columns ≥ vocab are embedding-table
    padding (``ModelConfig.vocab_padded``) and are masked with -1e30.
    ``aux``: the MoE load-balance loss, also returned as the metric
    ``"aux"``.  The other families have none (the reference's aux is
    zero there): the term and the metric are left out.
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
    if aux is None:
        return ce, {"loss": ce, "ce": ce}
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    spec: Params
    loss_fn: Callable[[Params, Batch, RunConfig],
                      tuple[torch.Tensor, dict[str, torch.Tensor]]]
    forward_fn: Callable[[Params, Batch, RunConfig], torch.Tensor]
    decode_fn: Callable[[Params, Batch, Any, RunConfig],
                        tuple[torch.Tensor, Any]] | None = None
    init_state_fn: Callable[..., Any] | None = None


def build(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe"):
        return _build_lm(cfg, TR)
    if fam == "vlm":
        return _build_vlm(cfg)
    if fam in ("audio", "encdec"):
        return _build_encdec(cfg)
    if fam == "ssm":
        return _build_lm(cfg, SM)
    if fam == "hybrid":
        return _build_lm(cfg, HY)
    if fam == "cnn":
        return _build_deepcam(cfg)
    raise ValueError(f"unknown family {fam!r}")


def _kv_init_state(cfg: ModelConfig):
    def init_state_fn(batch, max_len, dtype=torch.bfloat16, device="meta"):
        return TR.init_cache(cfg, batch, max_len, dtype, device=device)
    return init_state_fn


def _build_lm(cfg: ModelConfig, module) -> Model:
    """The reference's ``_build_transformer`` (dense and MoE) /
    ``_build_ssm`` / ``_build_hybrid``: a token LM whose ``module`` has
    ``lm_spec``, ``forward`` and ``decode_step``.  The decode state of
    each family:

    * dense, MoE: a KV cache of ``max_len`` rows, ``dtype`` bf16 by
      default;
    * ssm: the O(1) recurrent state, fp32 by default (``max_len`` does
      not size it);
    * hybrid: the recurrent states and a window of ``min(max_len,
      ATTN_WINDOW)`` rows a site (``max_len`` defaults to the window).
    """

    if module is TR:
        def loss_fn(params, batch, run):
            logits, aux = TR.forward_aux(params, batch["tokens"], cfg, run)
            return lm_loss(logits, batch["targets"], cfg.vocab_size, aux)
    else:
        def loss_fn(params, batch, run):
            logits = module.forward(params, batch["tokens"], cfg, run)
            return lm_loss(logits, batch["targets"], cfg.vocab_size)

    def forward_fn(params, batch, run):
        return module.forward(params, batch["tokens"], cfg, run)

    def decode_fn(params, batch, state, run):
        return module.decode_step(params, batch["tokens"], state, cfg, run)

    if module is SM:
        def init_state_fn(batch, max_len=0, dtype=torch.float32,
                          device="meta"):
            del max_len          # O(1) state: the context does not size it
            return SM.init_state(cfg, batch, dtype, device=device)
    elif module is HY:
        def init_state_fn(batch, max_len=HY.ATTN_WINDOW,
                          dtype=torch.bfloat16, device="meta"):
            return HY.init_state(cfg, batch, min(max_len, HY.ATTN_WINDOW),
                                 dtype, device=device)
    else:
        init_state_fn = _kv_init_state(cfg)

    return Model(cfg, module.lm_spec(cfg), loss_fn, forward_fn, decode_fn,
                 init_state_fn)


def _build_vlm(cfg: ModelConfig) -> Model:
    """The reference's ``_build_vlm``: the batch's ``prefix`` patch
    embeddings go before the tokens.  ``decode_fn`` takes no prefix: after
    the prefill the patches are in the KV cache."""

    def loss_fn(params, batch, run):
        logits, aux = TR.forward_aux(params, batch["tokens"], cfg, run,
                                     prefix_embeds=batch["prefix"])
        return lm_loss(logits, batch["targets"], cfg.vocab_size, aux)

    def forward_fn(params, batch, run):
        return TR.forward(params, batch["tokens"], cfg, run,
                          prefix_embeds=batch["prefix"])

    def decode_fn(params, batch, state, run):
        return TR.decode_step(params, batch["tokens"], state, cfg, run)

    return Model(cfg, TR.lm_spec(cfg), loss_fn, forward_fn, decode_fn,
                 _kv_init_state(cfg))


def _build_encdec(cfg: ModelConfig) -> Model:
    """The reference's ``_build_encdec``: the loss and the forward encode
    the batch's ``frames`` and decode the tokens against them;
    ``decode_fn`` attends a precomputed encoder output, the batch's
    ``memory`` (a request is encoded once, not once a token)."""

    def loss_fn(params, batch, run):
        memory = TR.encode(params, batch["frames"], cfg, run)
        logits, aux = TR.forward_aux(params, batch["tokens"], cfg, run,
                                     memory=memory)
        return lm_loss(logits, batch["targets"], cfg.vocab_size, aux)

    def forward_fn(params, batch, run):
        memory = TR.encode(params, batch["frames"], cfg, run)
        return TR.forward(params, batch["tokens"], cfg, run, memory=memory)

    def decode_fn(params, batch, state, run):
        return TR.decode_step(params, batch["tokens"], state, cfg, run,
                              memory=batch["memory"])

    return Model(cfg, TR.lm_spec(cfg), loss_fn, forward_fn, decode_fn,
                 _kv_init_state(cfg))


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


def _token_lengths(cfg: ModelConfig, shape: ShapeSpec) -> tuple[int, int]:
    """(token_len, prefix_len): a VLM's patches count against the
    context."""
    if cfg.family == "vlm":
        return shape.seq_len - cfg.n_prefix_embeds, cfg.n_prefix_embeds
    return shape.seq_len, 0


def batch_schema(cfg: ModelConfig, shape: ShapeSpec,
                 per_device_batch: int | None = None
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one cell's input batch.

    DeepCAM takes images (B, H, W, 16) f32 and labels (B, H, W) int32 at
    the paper's resolution (``IMAGE_HW``) for a stem width of 64 or more,
    ``SMOKE_HW`` below, whatever the cell's kind (``shape.seq_len`` is not
    read).  A token LM's train cell takes tokens and targets (B, S), a
    prefill cell tokens (B, S), a decode cell one new token (B, 1)
    against a cache of ``seq_len`` (:func:`decode_state_specs`).  A VLM's
    train and prefill cells hold ``seq_len - n_prefix_embeds`` tokens and
    the ``prefix`` (B, n_prefix_embeds, D) bf16; an audio / enc-dec's
    train and prefill cells add the encoder's ``frames`` (B,
    seq_len // 8, D) bf16, its decode cell their encoding, ``memory``,
    of the same shape.  ``per_device_batch=None`` takes the cell's global
    batch.
    """
    B = per_device_batch if per_device_batch is not None else shape.global_batch
    fam = cfg.family
    if fam == "cnn":
        from repro_torch.configs.deepcam import IMAGE_HW, SMOKE_HW
        hw = IMAGE_HW if cfg.d_model >= 64 else SMOKE_HW
        return {"images": ((B, *hw, DC.IN_CHANNELS), torch.float32),
                "labels": ((B, *hw), torch.int32)}
    D = cfg.d_model
    frames = ((B, shape.seq_len // TR.FRAME_DOWNSAMPLE, D), torch.bfloat16)
    if shape.kind in ("train", "prefill"):
        toks, pref = _token_lengths(cfg, shape)
        out = {"tokens": ((B, toks), torch.int32)}
        if shape.kind == "train":
            out["targets"] = ((B, toks), torch.int32)
        if fam == "vlm":
            out["prefix"] = ((B, pref, D), torch.bfloat16)
        if fam in ("audio", "encdec"):
            out["frames"] = frames
        return out
    out = {"tokens": ((B, 1), torch.int32)}
    if fam in ("audio", "encdec"):
        out["memory"] = frames
    return out


def synthetic_batch(cfg: ModelConfig, shape: ShapeSpec, batch: int,
                    generator: torch.Generator | None,
                    device: str | torch.device = "cpu") -> Batch:
    """Random batch with :func:`batch_schema`'s schema, drawn from
    ``generator``: tokens in ``[0, vocab)``; DeepCAM labels in ``[0, 3)``;
    every float input (DeepCAM images, a VLM's prefix, an enc-dec's frames
    or memory) a float32 normal × 0.02 cast to its dtype.  Meta tensors,
    drawing nothing, when ``device`` is ``meta``."""
    out: Batch = {}
    for name, (shp, dt) in batch_schema(cfg, shape, batch).items():
        if torch.device(device).type == "meta":
            out[name] = torch.empty(shp, dtype=dt, device=device)
        elif name == "prefix":
            out[name] = MM.synthetic_prefix(cfg, shp[0], generator, dt,
                                            device)
        elif dt.is_floating_point:
            out[name] = torch.randn(shp, generator=generator,
                                    dtype=torch.float32,
                                    device=device).mul_(0.02).to(dt)
        else:
            high = DC.N_CLASSES if name == "labels" else max(cfg.vocab_size,
                                                              2)
            out[name] = torch.randint(0, high, shp, generator=generator,
                                      dtype=dt, device=device)
    return out


def decode_state_specs(cfg: ModelConfig, shape: ShapeSpec,
                       batch: int | None = None) -> Any:
    """The decode state of a decode cell (a cache of ``seq_len``) as meta
    tensors, which allocate nothing.  The cells model an *aligned* batch:
    the fill is a scalar, so the cache update is the one-slice write (the
    per-row (B,) fill is the continuous-batching engine's)."""
    model = build(cfg)
    if model.init_state_fn is None:
        raise ValueError(f"{cfg.name} has no decode path")
    B = batch if batch is not None else shape.global_batch
    state = model.init_state_fn(B, shape.seq_len)
    if hasattr(state, "length"):
        state = state._replace(length=torch.zeros(
            (), dtype=torch.int32, device="meta"))
    return state
