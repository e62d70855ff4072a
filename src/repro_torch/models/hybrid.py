"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention+MLP
block (port of ``repro.models.hybrid``) [arXiv:2411.15242].

The backbone is a stack of Mamba-2 layers.  After every ``hybrid_group``
of them, one shared transformer block (one set of attention and MLP
weights, reused at every site) runs on the hidden state, with per-site
input norms that de-share it (``site_ln``, ``site_ln_mlp``).

The reference's hybrid ignores ``run.remat``, and so does the port.

Decoding (:class:`HybridState`, :func:`init_state`, :func:`decode_step`)
steps every Mamba-2 layer's recurrent state and keeps one sliding-window
KV cache per site, ``window`` rows (at most :data:`ATTN_WINDOW`), as the
reference does: token ``t`` is written to row ``t % window`` and roped at
position ``min(t, window - 1)``, and the site attends rows ``0 .. t %
window`` — so once the window has wrapped it attends only the rows up to
the one just written, not the whole window.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TR
from repro_torch.models.params import stack_layers, unstack_layers

Params = Any

#: the shared attention's sliding window for decode (KV rows per site)
ATTN_WINDOW = 4096


class HybridState(NamedTuple):
    ssm: SM.SSMState         # (L, ...) stacked Mamba-2 states
    attn_k: torch.Tensor     # (n_sites, B, window, K, hd) sliding windows
    attn_v: torch.Tensor
    length: torch.Tensor     # (B,) tokens seen


def n_shared_sites(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_group if cfg.hybrid_group else 0


def hybrid_spec(cfg: ModelConfig) -> Params:
    n_sites = n_shared_sites(cfg)
    return {
        "embed": L.embed_spec(cfg),
        "ssm_blocks": stack_layers(
            lambda: {"ln": L.rmsnorm_spec(cfg.d_model),
                     "ssm": SM.ssm_spec(cfg)}, cfg.n_layers),
        # ONE shared attention+MLP block (the zamba trick)
        "shared": {"attn": L.attention_spec(cfg), "mlp": L.mlp_spec(cfg)},
        # per-site input norms (de-sharing)
        "site_ln": stack_layers(lambda: L.rmsnorm_spec(cfg.d_model),
                                max(n_sites, 1)),
        "site_ln_mlp": stack_layers(lambda: L.rmsnorm_spec(cfg.d_model),
                                    max(n_sites, 1)),
        "ln_f": L.rmsnorm_spec(cfg.d_model),
    }


#: the name the model facade builds every token LM's spec by
lm_spec = hybrid_spec


def schedule(cfg: ModelConfig) -> list[tuple[str, int, int]]:
    """The reference's order of segments and sites: ``("ssm", start,
    stop)`` runs Mamba-2 layers ``start:stop``, ``("site", i, i)`` the
    shared block at site i.  A site follows each full segment while
    layers remain, and also the last segment when ``n_sites · k`` is the
    depth: (4, 2) runs two sites, the second after the last layer; (38,
    6) runs six and then a trailing two-layer segment with none."""
    k = cfg.hybrid_group if cfg.hybrid_group else cfg.n_layers
    n_sites = n_shared_sites(cfg)
    out: list[tuple[str, int, int]] = []
    done = site = 0
    while done < cfg.n_layers:
        seg = min(k, cfg.n_layers - done)
        out.append(("ssm", done, done + seg))
        done += seg
        if site < n_sites and (done < cfg.n_layers
                               or n_sites * k == cfg.n_layers):
            out.append(("site", site, site))
            site += 1
    return out


def _shared_block(params: Params, ln: Params, ln2: Params, x: torch.Tensor,
                  cfg: ModelConfig, run: RunConfig, positions: torch.Tensor,
                  kv_cache=None, cache_len=None):
    """The shared block at one site, with that site's norms ``ln`` and
    ``ln2`` → x; with a ``kv_cache`` (decode) → (x, new_kv_cache)."""
    h = L.attention_apply(params["shared"]["attn"],
                          L.rmsnorm_apply(ln, x, cfg.norm_eps, run), cfg,
                          run, positions=positions, kv_cache=kv_cache,
                          cache_len=cache_len)
    if kv_cache is not None:
        h, new_cache = h
    x, y = L.rmsnorm_residual_apply(ln2, x, h, cfg.norm_eps, run)
    x = x + L.mlp_apply(params["shared"]["mlp"], y, cfg, run)
    return x if kv_cache is None else (x, new_cache)


def matmul_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Analytic FLOPs of the matmuls of :func:`forward` outside the SSD
    scans: per Mamba-2 layer in_proj and out_proj, per site the shared
    block's projections, QKᵀ, PV and MLP products, plus the
    unembedding."""
    a = TR.attention_flops(cfg, batch, seq)
    site = a["proj"] + a["qk_pv"] + TR.mlp_flops(cfg, batch, seq)
    return (cfg.n_layers * SM.layer_flops(cfg, batch, seq)
            + n_shared_sites(cfg) * site
            + 2 * batch * seq * cfg.d_model * cfg.vocab_padded)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            run: RunConfig) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab_padded), in
    :func:`schedule`'s order; the reference's auxiliary loss is 0."""
    x = L.embed_apply(params["embed"], tokens, run)
    positions = torch.arange(x.shape[1], device=x.device)
    layers = unstack_layers(params["ssm_blocks"])
    lns = unstack_layers(params["site_ln"])
    lns2 = unstack_layers(params["site_ln_mlp"])
    for kind, a, b in schedule(cfg):
        if kind == "ssm":
            for lp in layers[a:b]:
                x = SM.layer_apply(lp, x, cfg, run)
        else:
            x = _shared_block(params, lns[a], lns2[a], x, cfg, run,
                              positions)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    return L.unembed_apply(params["embed"], x, run)


def init_state(cfg: ModelConfig, batch: int, window: int = ATTN_WINDOW,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "meta") -> HybridState:
    """Zero decode state: fp32 Mamba-2 states, ``dtype`` windows (on
    ``meta``, the default, the shapes alone)."""
    n_sites = max(n_shared_sites(cfg), 1)
    kv_shape = (n_sites, batch, window, cfg.n_kv_heads, cfg.head_dim)
    return HybridState(
        ssm=SM.ssm_state_spec(cfg, batch, torch.float32, device=device),
        attn_k=torch.zeros(kv_shape, dtype=dtype, device=device),
        attn_v=torch.zeros(kv_shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def decode_step(params: Params, tokens: torch.Tensor, state: HybridState,
                cfg: ModelConfig, run: RunConfig
                ) -> tuple[torch.Tensor, HybridState]:
    """One-token decode in :func:`schedule`'s order: each Mamba-2 layer's
    recurrent step, and at each site the shared block against that site's
    sliding window (write row ``length % window``, RoPE position
    ``min(length, window - 1)``, the rows up to the written one
    attended) → (logits (B, 1, vocab_padded), the new state)."""
    x = L.embed_apply(params["embed"], tokens, run)
    window = state.attn_k.shape[2]
    slot = state.length % window
    pos = torch.clamp(state.length, max=window - 1)
    pos2d = pos[:, None] if pos.dim() else pos.reshape(1, 1)
    layers = unstack_layers(params["ssm_blocks"])
    lns = unstack_layers(params["site_ln"])
    lns2 = unstack_layers(params["site_ln_mlp"])
    convs, ssds = [], []
    new_k, new_v = list(state.attn_k), list(state.attn_v)
    for kind, a, b in schedule(cfg):
        if kind == "ssm":
            for i in range(a, b):
                x, st = SM.layer_step(
                    layers[i], x, SM.SSMState(state.ssm.conv[i],
                                              state.ssm.ssd[i]), cfg, run)
                convs.append(st.conv)
                ssds.append(st.ssd)
        else:
            x, (new_k[a], new_v[a]) = _shared_block(
                params, lns[a], lns2[a], x, cfg, run, pos2d,
                kv_cache=(new_k[a], new_v[a]), cache_len=slot)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    logits = L.unembed_apply(params["embed"], x, run)
    return logits, HybridState(
        ssm=SM.SSMState(conv=torch.stack(convs), ssd=torch.stack(ssds)),
        attn_k=torch.stack(new_k), attn_v=torch.stack(new_v),
        length=state.length + 1)
