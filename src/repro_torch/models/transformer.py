"""Decoder-only dense LM (port of ``repro.models.transformer``).

The reference scans the layer stack with ``jax.lax.scan``; here the scan
is a Python loop over the leading ``n_layers`` axis of the stacked
parameters (``params.unstack_layers``: each layer's leaves are views into
the stack).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.params import stack_layers, unstack_layers

Params = Any


def block_spec(cfg: ModelConfig) -> Params:
    return {
        "ln_attn": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln_mlp": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, run: RunConfig,
                positions: torch.Tensor) -> torch.Tensor:
    """One pre-norm transformer block (the residual add and the next norm
    fuse into one pass under ``fusion="static"``)."""
    h = L.attention_apply(p["attn"], L.rmsnorm_apply(p["ln_attn"], x,
                                                     cfg.norm_eps, run),
                          cfg, run, positions=positions)
    x, y = L.rmsnorm_residual_apply(p["ln_mlp"], x, h, cfg.norm_eps, run)
    return x + L.mlp_apply(p["mlp"], y, cfg, run)


def lm_spec(cfg: ModelConfig) -> Params:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the transformer LM is the dense "
            "family's")
    return {
        "embed": L.embed_spec(cfg),
        "blocks": stack_layers(lambda: block_spec(cfg), cfg.n_layers),
        "ln_f": L.rmsnorm_spec(cfg.d_model),
    }


def matmul_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Analytic FLOPs of every matmul in :func:`forward`: per layer wq, wk,
    wv, wo, QKᵀ, PV and the three MLP products, plus the unembedding."""
    T, D, H, K, hd = batch * seq, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    per_layer = (2 * 2 * T * D * H * hd             # wq, wo
                 + 2 * 2 * T * D * K * hd           # wk, wv
                 + 2 * 2 * batch * H * seq * seq * hd   # QKᵀ, PV
                 + 3 * 2 * T * D * cfg.d_ff)        # gate, up, down
    return cfg.n_layers * per_layer + 2 * T * D * cfg.vocab_padded


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            run: RunConfig) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab_padded)."""
    x = L.embed_apply(params["embed"], tokens, run)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in unstack_layers(params["blocks"]):
        x = block_apply(lp, x, cfg, run, positions)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    return L.unembed_apply(params["embed"], x, run)
