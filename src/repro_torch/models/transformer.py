"""Decoder-only LM (dense, MoE and VLM blocks) and the encoder-decoder
transformer (port of ``repro.models.transformer``).

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

A MoE block keeps its router product under ``"dots"`` and recomputes
its expert products (``models/moe.py``).

The families, as the reference builds them:

* ``dense`` and ``vlm``: a block of attention and MLP; a VLM's patch
  embeddings are prepended to the token embeddings (``prefix_embeds``)
  and cut off after the final norm;
* ``moe``: the MLP is the routed-expert block, whose load-balance aux
  loss each block returns (:func:`block_apply`) and :func:`forward_aux`
  sums;
* ``audio`` / ``encdec``: an encoder stack (``enc_blocks``,
  ``enc_ln_f``) over precomputed frame embeddings (:func:`encode`), and
  decoder blocks that add a cross-attention to its output (``memory``).
  The encoder's self-attention is causal and roped, as the reference's
  (its ``encode`` calls ``block_apply`` with the default ``causal``), so
  under ``flash`` it takes the kernel.

Decoding (:class:`DecodeState`, :func:`init_cache`, :func:`decode_step`)
runs one token per sequence against a KV cache per layer; an enc-dec
decoder also attends the encoder's ``memory`` at every step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.configs.seamless_m4t_large_v2 import FRAME_DOWNSAMPLE
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.params import stack_layers, unstack_layers

Params = Any

#: the families this module builds
FAMILIES = ("dense", "moe", "vlm", "audio", "encdec")


def block_spec(cfg: ModelConfig, cross_attn: bool = False) -> Params:
    spec: dict[str, Any] = {
        "ln_attn": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln_mlp": L.rmsnorm_spec(cfg.d_model),
    }
    if cfg.family == "moe":
        spec["moe"] = M.moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(cfg)
    if cross_attn:
        spec["ln_cross"] = L.rmsnorm_spec(cfg.d_model)
        spec["cross"] = L.attention_spec(cfg)
    return spec


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, run: RunConfig,
                positions: torch.Tensor, kv_cache=None, cache_len=None,
                memory: torch.Tensor | None = None):
    """One pre-norm transformer block → (x, new_kv_cache, aux): the KV
    cache is None without a ``kv_cache`` (decode), aux the MoE block's
    load-balance loss and None for the other families.

    The residual add and the next norm fuse into one pass under
    ``fusion="static"``.  With ``memory`` (an enc-dec decoder) the order
    is the reference's: ``x + h``, the cross-attention on
    ``ln_cross(x)``, then the residual seam adds its output."""
    h = L.attention_apply(p["attn"], L.rmsnorm_apply(p["ln_attn"], x,
                                                     cfg.norm_eps, run),
                          cfg, run, positions=positions, kv_cache=kv_cache,
                          cache_len=cache_len)
    new_cache = None
    if kv_cache is not None:
        h, new_cache = h
    if memory is not None:
        x = x + h
        h = L.attention_apply(p["cross"], L.rmsnorm_apply(
            p["ln_cross"], x, cfg.norm_eps, run), cfg, run,
            positions=positions, causal=False, memory=memory)
    x, y = L.rmsnorm_residual_apply(p["ln_mlp"], x, h, cfg.norm_eps, run)
    y, aux = ffn_apply(p, y, cfg, run)
    return x + y, new_cache, aux


def ffn_apply(p: Params, y: torch.Tensor, cfg: ModelConfig, run: RunConfig):
    """A block's feed-forward on the normed ``y`` → (out, aux): the MoE
    block and its load-balance loss, or the MLP and None."""
    if cfg.family == "moe":
        return M.moe_apply(p["moe"], y, cfg, run)
    return L.mlp_apply(p["mlp"], y, cfg, run), None


def lm_spec(cfg: ModelConfig) -> Params:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the transformer LM builds "
            f"{FAMILIES}")
    cross = cfg.family in ("encdec", "audio")
    spec: dict[str, Any] = {
        "embed": L.embed_spec(cfg),
        "blocks": stack_layers(lambda: block_spec(cfg, cross_attn=cross),
                               cfg.n_layers),
        "ln_f": L.rmsnorm_spec(cfg.d_model),
    }
    if cfg.n_encoder_layers:
        spec["enc_blocks"] = stack_layers(lambda: block_spec(cfg),
                                          cfg.n_encoder_layers)
        spec["enc_ln_f"] = L.rmsnorm_spec(cfg.d_model)
    return spec


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


def moe_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Matmul FLOPs of one MoE block: the router (2·B·S·D·E), the three
    expert products over the capacity-padded E·C slots of each group,
    and the shared expert's MLP where there is one."""
    E, D = cfg.n_experts, cfg.d_model
    C = M._capacity(seq, cfg)
    out = 2 * batch * seq * D * E + 3 * 2 * batch * E * C * D * cfg.d_ff
    if cfg.moe_shared_ff:
        n = 3 if cfg.act in L.GATED_ACTS else 2
        out += n * 2 * batch * seq * D * cfg.moe_shared_ff
    return out


def cross_flops(cfg: ModelConfig, batch: int, seq: int, mem: int) -> int:
    """Matmul FLOPs of one cross-attention: wq and wo over the ``seq``
    queries, wk and wv over the ``mem`` memory rows, QKᵀ and PV between
    them."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return (2 * 2 * batch * seq * D * H * hd
            + 2 * 2 * batch * mem * D * K * hd
            + 2 * 2 * batch * H * seq * mem * hd)


def matmul_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Analytic FLOPs of every matmul in :func:`forward` (and
    :func:`encode`) at a cell of ``seq``: per layer wq, wk, wv, wo, QKᵀ,
    PV and the MLP's (or MoE block's) products, plus the unembedding.

    A VLM's ``seq`` holds its ``n_prefix_embeds`` patches, which the
    unembedding does not see; an enc-dec cell runs its encoder over
    ``seq // FRAME_DOWNSAMPLE`` frames and each decoder layer adds a
    cross-attention to them."""
    a = attention_flops(cfg, batch, seq)
    per_layer = a["proj"] + a["qk_pv"]
    per_layer += (moe_flops(cfg, batch, seq) if cfg.family == "moe"
                  else mlp_flops(cfg, batch, seq))
    out_rows = seq - (cfg.n_prefix_embeds if cfg.family == "vlm" else 0)
    total = (cfg.n_layers * per_layer
             + 2 * batch * out_rows * cfg.d_model * cfg.vocab_padded)
    if cfg.family in ("encdec", "audio"):
        mem = seq // FRAME_DOWNSAMPLE
        e = attention_flops(cfg, batch, mem)
        total += cfg.n_encoder_layers * (e["proj"] + e["qk_pv"]
                                         + mlp_flops(cfg, batch, mem))
        total += cfg.n_layers * cross_flops(cfg, batch, seq, mem)
    return total


def _blocks(blocks: Params, x: torch.Tensor, cfg: ModelConfig,
            run: RunConfig, positions: torch.Tensor,
            memory: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer loop (the reference's ``_scan_blocks``), each block under
    ``run.remat`` → (x, the summed aux loss, None when no block has
    one)."""
    aux = None
    for lp in unstack_layers(blocks):
        x, _, a = L.remat_apply(_scan_body, run, lp, x, cfg, run, positions,
                                memory)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _scan_body(lp: Params, x: torch.Tensor, cfg: ModelConfig,
               run: RunConfig, positions: torch.Tensor,
               memory: torch.Tensor | None):
    """One block between the reference's two activation constraints."""
    x = constrain(x, run, "batch", "seq", None)
    x, cache, aux = block_apply(lp, x, cfg, run, positions, None, None,
                                memory)
    return constrain(x, run, "batch", "seq", None), cache, aux


def encode(params: Params, embeds: torch.Tensor, cfg: ModelConfig,
           run: RunConfig) -> torch.Tensor:
    """The encoder stack over precomputed frame embeddings (B, Sm, D) →
    the memory (B, Sm, D), in the compute dtype."""
    x = embeds.to(run.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _blocks(params["enc_blocks"], x, cfg, run, positions)
    return L.rmsnorm_apply(params["enc_ln_f"], x, cfg.norm_eps, run)


def forward_aux(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                run: RunConfig, memory: torch.Tensor | None = None,
                prefix_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Full-sequence forward → (logits (B, S, vocab_padded), the summed
    MoE aux loss, None for the other families).

    ``prefix_embeds`` (B, P, D): a VLM's patch embeddings, prepended to
    the token embeddings; positions run over the whole sequence, and the
    P prefix rows are cut off after the final norm.  ``memory``: an
    enc-dec decoder's encoder output (:func:`encode`)."""
    x = L.embed_apply(params["embed"], tokens, run)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _blocks(params["blocks"], x, cfg, run, positions, memory)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    return L.unembed_apply(params["embed"], x, run), aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            run: RunConfig, memory: torch.Tensor | None = None,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`forward_aux`'s logits."""
    return forward_aux(params, tokens, cfg, run, memory, prefix_embeds)[0]


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
                cfg: ModelConfig, run: RunConfig,
                memory: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, DecodeState]:
    """One new token per sequence against the KV cache → (logits (B, 1,
    vocab_padded), the state one token on).  tokens: (B, 1).

    ``state.length`` may be per sequence (B,) — continuous batching — or
    a scalar (an aligned batch); :func:`layers.cache_update` writes each
    accordingly.  The caches come back stacked anew, as the reference's
    scan returns them.  ``memory``: an enc-dec decoder's encoder output,
    which every step's cross-attention attends whole.
    """
    x = L.embed_apply(params["embed"], tokens, run)
    positions = (state.length[:, None] if state.length.dim()
                 else state.length.reshape(1, 1))     # RoPE position(s)
    new_k, new_v = [], []
    for lp, ck, cv in zip(unstack_layers(params["blocks"]), state.k,
                          state.v):
        x, (ck, cv), _ = block_apply(lp, x, cfg, run, positions,
                                     kv_cache=(ck, cv),
                                     cache_len=state.length, memory=memory)
        new_k.append(ck)
        new_v.append(cv)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    logits = L.unembed_apply(params["embed"], x, run)
    return logits, DecodeState(k=torch.stack(new_k), v=torch.stack(new_v),
                               length=state.length + 1)
