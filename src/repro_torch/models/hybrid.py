"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention+MLP
block (port of ``repro.models.hybrid``) [arXiv:2411.15242].

The backbone is a stack of Mamba-2 layers.  After every ``hybrid_group``
of them, one shared transformer block (one set of attention and MLP
weights, reused at every site) runs on the hidden state, with per-site
input norms that de-share it (``site_ln``, ``site_ln_mlp``).

The reference's hybrid ignores ``run.remat``, and so does the port.  Its
decode path — ``ATTN_WINDOW``, ``HybridState``, ``init_state`` and
``decode_step``, a sliding-window KV cache per site — comes with serving:
``init_state`` and ``decode_step`` raise until then.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TR
from repro_torch.models.params import stack_layers, unstack_layers

Params = Any

_DECODE = ("the hybrid decode path (HybridState, init_state, decode_step) "
           "comes with serving (ROADMAP queue 1, decode and serving)")


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
                  cfg: ModelConfig, run: RunConfig, positions: torch.Tensor
                  ) -> torch.Tensor:
    """The shared block at one site, with that site's norms ``ln`` and
    ``ln2``."""
    h = L.attention_apply(params["shared"]["attn"],
                          L.rmsnorm_apply(ln, x, cfg.norm_eps, run), cfg,
                          run, positions=positions)
    x, y = L.rmsnorm_residual_apply(ln2, x, h, cfg.norm_eps, run)
    return x + L.mlp_apply(params["shared"]["mlp"], y, cfg, run)


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


def init_state(cfg: ModelConfig, batch: int, *args, **kwargs):
    raise NotImplementedError(_DECODE)


def decode_step(params: Params, tokens: torch.Tensor, state: Any,
                cfg: ModelConfig, run: RunConfig):
    raise NotImplementedError(_DECODE)
