"""Decoder-only dense LM (port of ``repro.models.transformer``).

The reference scans the layer stack with ``jax.lax.scan``; here the scan
is a Python loop over the leading ``n_layers`` axis of the stacked
parameters (``params.unstack_layers``: each layer's leaves are views into
the stack).

``run.remat`` checkpoints each block (``layers.remat_apply``), as the
reference wraps its scan body.  What the backward keeps of a block:

* ``"none"``: whatever autograd saves — the inputs of every product and
  norm, the fp32 scores and the softmax output of the einsum route;
* ``"dots"``: the block's input and the outputs of its seven products
  against a weight (q, k, v, the o projection, gate, up, down; up and
  down only for an ungated act) — the reference's
  ``checkpoint_dots_with_no_batch_dims``.  The backward recomputes the
  rest: the norms, RoPE, the batched QKᵀ and PV, the softmax, the act
  and every ``repro_torch::`` custom op (fused norms, SwiGLU, flash);
* ``"full"``: the block's input alone; the backward recomputes the
  block's forward up to its last product, whose output no backward
  reads.

Decoding (:class:`DecodeState`, :func:`init_cache`, :func:`decode_step`)
runs one token per sequence against a KV cache per layer.
"""

from __future__ import annotations

from typing import Any, NamedTuple

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
                positions: torch.Tensor, kv_cache=None, cache_len=None):
    """One pre-norm transformer block → x (the residual add and the next
    norm fuse into one pass under ``fusion="static"``); with a
    ``kv_cache`` (decode) → (x, new_kv_cache)."""
    h = L.attention_apply(p["attn"], L.rmsnorm_apply(p["ln_attn"], x,
                                                     cfg.norm_eps, run),
                          cfg, run, positions=positions, kv_cache=kv_cache,
                          cache_len=cache_len)
    if kv_cache is not None:
        h, new_cache = h
    x, y = L.rmsnorm_residual_apply(p["ln_mlp"], x, h, cfg.norm_eps, run)
    x = x + L.mlp_apply(p["mlp"], y, cfg, run)
    return x if kv_cache is None else (x, new_cache)


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


def attention_flops(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Matmul FLOPs of one attention block: ``"proj"`` (wq, wk, wv, wo)
    and ``"qk_pv"`` (the batched QKᵀ and PV)."""
    T, D, H, K, hd = batch * seq, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    return {"proj": 2 * 2 * T * D * H * hd + 2 * 2 * T * D * K * hd,
            "qk_pv": 2 * 2 * batch * H * seq * seq * hd}


def mlp_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Matmul FLOPs of one MLP: three products gated, two ungated (the
    reference's ``param_count`` multiplier)."""
    n = 3 if cfg.act in L.GATED_ACTS else 2
    return n * 2 * batch * seq * cfg.d_model * cfg.d_ff


def matmul_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Analytic FLOPs of every matmul in :func:`forward`: per layer wq, wk,
    wv, wo, QKᵀ, PV and the MLP's products, plus the unembedding."""
    a = attention_flops(cfg, batch, seq)
    per_layer = a["proj"] + a["qk_pv"] + mlp_flops(cfg, batch, seq)
    return (cfg.n_layers * per_layer
            + 2 * batch * seq * cfg.d_model * cfg.vocab_padded)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            run: RunConfig) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab_padded)."""
    x = L.embed_apply(params["embed"], tokens, run)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in unstack_layers(params["blocks"]):
        x = L.remat_apply(block_apply, run, lp, x, cfg, run, positions)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    return L.unembed_apply(params["embed"], x, run)


# --------------------------------------------------------------------------
# Decode (one token against the KV cache)
# --------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """KV caches stacked over layers: (L, B, S_max, K, hd) each."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor     # (B,) current fill, or () for an aligned batch


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "meta") -> DecodeState:
    """An empty cache: zero K/V and fill (on ``meta``, the default, the
    shapes alone, as the reference's abstract spec)."""
    k, v = L.kv_cache_spec(cfg, batch, max_len, dtype, device=device)
    return DecodeState(k=k, v=v, length=torch.zeros(
        (batch,), dtype=torch.int32, device=device))


def decode_step(params: Params, tokens: torch.Tensor, state: DecodeState,
                cfg: ModelConfig, run: RunConfig
                ) -> tuple[torch.Tensor, DecodeState]:
    """One new token per sequence against the KV cache → (logits (B, 1,
    vocab_padded), the state one token on).  tokens: (B, 1).

    ``state.length`` may be per sequence (B,) — continuous batching — or
    a scalar (an aligned batch); :func:`layers.cache_update` writes each
    accordingly.  The caches come back stacked anew, as the reference's
    scan returns them.
    """
    x = L.embed_apply(params["embed"], tokens, run)
    positions = (state.length[:, None] if state.length.dim()
                 else state.length.reshape(1, 1))     # RoPE position(s)
    new_k, new_v = [], []
    for lp, ck, cv in zip(unstack_layers(params["blocks"]), state.k,
                          state.v):
        x, (ck, cv) = block_apply(lp, x, cfg, run, positions,
                                  kv_cache=(ck, cv), cache_len=state.length)
        new_k.append(ck)
        new_v.append(cv)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    logits = L.unembed_apply(params["embed"], x, run)
    return logits, DecodeState(k=torch.stack(new_k), v=torch.stack(new_v),
                               length=state.length + 1)
