"""Mamba-2 (SSD, state-space duality) sequence mixer and LM (port of
``repro.models.ssm``) [arXiv:2405.21060].

Training and prefill use the chunked SSD dual form: the sequence is split
into chunks of Q steps; inside a chunk the recurrence is a masked
quadratic form, across chunks a linear recurrence carries the (H, P, N)
state::

    y_t = C_t^T s_t,   s_t = a_t * s_{t-1} + dt_t * B_t x_t^T,
    a_t = exp(-exp(A_log) * dt_t)

``run.ssd_impl`` picks the scan: ``"xla"`` runs :func:`ssd_chunked` in
torch ops (the reference's jnp form, in the compute dtype), ``"kernel"``
the hand-written ``ssd_scan`` kernel on fp32 operands
(:mod:`repro_torch.kernels.ssd_scan`), as the reference's Pallas route.
The layer scan is a Python loop over the stacked parameters; each layer
body pins its input and output activations as the reference's does
(``sharding.constrain``: a redistribution on a mesh, nothing on one
device).  ``run.remat`` checkpoints each layer body as the reference does
(``layers.remat_apply``; under ``"dots"`` the backward keeps in_proj's
and out_proj's outputs and recomputes the conv, the scan — its einsums,
or the ``ssd_scan`` op — and the gated norm).

Decoding (:class:`SSMState`, :func:`init_state`, :func:`decode_step`) is
the O(1) recurrent step on a persistent state: a rolling conv buffer and
the (H, P, N) SSD state per layer.  Like the reference, it runs the
recurrence in the compute dtype (bf16 under O1) and stores the result
back in the state's dtype.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.distributed.sharding import constrain, is_dtensor
from repro_torch.models.params import P, stack_layers, unstack_layers

Params = Any



class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, W-1, d_conv_in)  rolling conv buffer
    ssd: torch.Tensor     # (B, H, P, N)         recurrent state


def ssm_spec(cfg: ModelConfig) -> Params:
    D, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv_width
    conv_ch = di + 2 * G * N
    return {
        "in_proj": P((D, 2 * di + 2 * G * N + H), ("embed", "ssm_inner")),
        "conv_w": P((W, conv_ch), (None, "ssm_inner")),
        "conv_b": P((conv_ch,), ("ssm_inner",), "zeros"),
        "A_log": P((H,), (None,), "zeros"),
        "D_skip": P((H,), (None,), "ones"),
        "dt_bias": P((H,), (None,), "zeros"),
        "norm": L.rmsnorm_spec(di),
        "out_proj": P((di, D), ("ssm_inner", "embed")),
    }


def _split_proj(z: torch.Tensor, cfg: ModelConfig):
    """(zg, xi, B, C, dt) of the in_proj output (``torch.split`` takes
    sizes where ``jnp.split`` takes cut indices)."""
    di, G, N, H = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(z, [di, di, G * N, G * N, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d, x: (B, S, C), w: (W, C).

    The reference's shifted-product sum, in its order: in bf16 every
    product and partial sum rounds, which ``F.conv1d`` (one fp32
    accumulation) would not."""
    W, S = w.shape[0], x.shape[1]
    if is_dtensor(x):
        # the same zero rows by a concatenation: older torch's DTensor
        # fails on ``F.pad``
        zeros = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
        xp = torch.cat([zeros, x], dim=1)
    else:
        xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def ssd_chunked(xh: torch.Tensor, a_log_dt: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD scan from a zero state.

    xh: (B, S, H, P) head-split inputs (already scaled by dt);
    a_log_dt: (B, S, H) per-step log-decay (negative);
    B_, C_: (B, S, N) (groups already broadcast).
    Returns y: (B, S, H, P).  The reference also returns the final state,
    which none of its callers reads (decoding starts from its own state,
    not from a prefill); the state after the last chunk is not formed
    here.

    The dtypes follow the reference's promotion: the products run in
    xh's dtype, ``cum`` and the decays in fp32, the masked quadratic form
    ``M`` is cast to xh's dtype, and the inter-chunk state is carried in
    xh's dtype.  The three-operand einsums are split where XLA splits
    them: the chunk states as ``(x·w)`` then the product with B over the
    chunk; the inter-chunk output as ``C·state`` then times ``exp(cum)``.
    """
    Bsz, S, H, Pd = xh.shape
    N = B_.shape[-1]
    nc = S // chunk
    dt = xh.dtype
    x_c = xh.reshape(Bsz, nc, chunk, H, Pd)
    a_c = a_log_dt.reshape(Bsz, nc, chunk, H)
    B_c = B_.reshape(Bsz, nc, chunk, N)
    C_c = C_.reshape(Bsz, nc, chunk, N)

    cum = torch.cumsum(a_c, dim=2)                       # (B, nc, Q, H)
    total = cum[:, :, -1, :]                             # (B, nc, H)

    # intra-chunk: M[i, j] = exp(cum_i - cum_j) * (C_i . B_j), i >= j; the
    # mask goes on BEFORE the exp: for j > i the exponent is positive and
    # unbounded, and exp-then-mask sends inf into the backward pass
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    iq = torch.arange(chunk, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    decay = torch.where(causal, seg, float("-inf")).exp()
    scores = torch.einsum("bcin,bcjn->bcij", C_c, B_c)   # (B, nc, Q, Q)
    M = (scores[..., None] * decay).to(dt)               # (B, nc, Q, Q, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, x_c)

    # the state before each chunk: s_0 = 0, s_{c+1} = exp(total_c) s_c +
    # sum_j exp(total_c - cum_j) B_j x_j over chunk c
    s = torch.zeros((Bsz, H, Pd, N), dtype=dt, device=xh.device)
    prev = [s]
    if nc > 1:
        last = slice(0, nc - 1)
        w_state = torch.exp(total[:, last, None, :] - cum[:, last])
        xw = x_c[:, last] * w_state.to(dt)[..., None]    # (B, nc-1, Q, H, P)
        states = torch.einsum("bcqn,bcqhp->bchpn", B_c[:, last], xw)
        for c in range(nc - 1):
            s = s * torch.exp(total[:, c]).to(dt)[:, :, None, None] \
                + states[:, c]
            prev.append(s)
    prev_states = torch.stack(prev, dim=1)               # (B, nc, H, P, N)

    # inter-chunk contribution: y_i += exp(cum_i) * (C_i . s_prev)
    w_in = torch.exp(cum).to(dt)                         # (B, nc, Q, H)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", C_c, prev_states) \
        * w_in[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, H, Pd)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``, no threshold; PyTorch's
    ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, run: RunConfig,
              state: SSMState | None = None
              ) -> tuple[torch.Tensor, SSMState | None]:
    """Mamba-2 block: ``state=None`` → chunked prefill, (out, None); with
    a ``state`` → the single-step decode, (out, new state)."""
    B, S, _ = x.shape
    di, G, N, H = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_head_dim
    cd = run.compute_dtype
    z = L.wdot("bsd,de->bse", x.to(cd), p["in_proj"].to(cd))
    zg, xi, Bc, Cc, dt_raw = _split_proj(z, cfg)

    conv_in = torch.cat([xi, Bc, Cc], dim=-1)            # (B, S, di+2GN)
    w, b = p["conv_w"].to(cd), p["conv_b"].to(cd)
    if state is None:
        conv = _causal_conv(conv_in, w, b)
    else:
        buf = torch.cat([state.conv.to(cd), conv_in], dim=1)
        conv = _causal_conv(buf, w, b)[:, -S:]
        new_conv = buf[:, -(cfg.ssm_conv_width - 1):]
    conv = F.silu(conv)
    xi, Bc, Cc = torch.split(conv, [di, G * N, G * N], dim=-1)

    dt = _softplus(dt_raw.float() + p["dt_bias"].float())          # (B,S,H)
    A = -torch.exp(p["A_log"].float())                             # (H,)
    a_log_dt = A * dt                                              # ≤ 0

    xh = xi.reshape(B, S, H, Pd) * dt[..., None].to(cd)
    Bn = Bc.reshape(B, S, G, N)[:, :, 0, :]                        # group 0
    Cn = Cc.reshape(B, S, G, N)[:, :, 0, :]

    new_state = None
    if state is not None:
        # the one-step recurrence, in the compute dtype (the reference's)
        a = torch.exp(a_log_dt[:, 0]).to(cd)                       # (B, H)
        if is_dtensor(xh):
            # the same products by broadcasting: older torch's DTensor
            # cannot flatten einsum's (h, p) with p sharded
            s = state.ssd.to(cd) * a[:, :, None, None] \
                + Bn[:, 0, None, None, :].to(cd) * xh[:, 0, :, :, None]
            y = (Cn[:, 0, None, None, :].to(cd) * s).sum(-1)[:, None]
        else:
            s = state.ssd.to(cd) * a[:, :, None, None] + torch.einsum(
                "bn,bhp->bhpn", Bn[:, 0].to(cd), xh[:, 0])
            y = torch.einsum("bn,bhpn->bhp", Cn[:, 0].to(cd), s)[:, None]
        y = y.reshape(B, S, H, Pd)
        new_state = SSMState(conv=new_conv.to(state.conv.dtype),
                             ssd=s.to(state.ssd.dtype))
    elif run.ssd_impl == "kernel":
        from repro_torch.kernels.ssd_scan.ops import ssd_scan_model_layout
        y = ssd_scan_model_layout(xh.float(), a_log_dt, Bn.float(),
                                  Cn.float(), min(cfg.ssm_chunk, S)).to(cd)
    else:
        y = ssd_chunked(xh, a_log_dt, Bn, Cn, min(cfg.ssm_chunk, S))

    y = y + xh * p["D_skip"].to(cd)[None, None, :, None]
    if is_dtensor(y):
        # flattening (h, p) over a sharded p fails in older torch's
        # DTensor: move a decode state's p shard onto h first
        from torch.distributed.tensor import Shard
        y = y.redistribute(y.device_mesh, [Shard(2) if pl == Shard(3)
                                           else pl for pl in y.placements])
    y = y.reshape(B, S, di)
    y = L.rmsnorm_apply(p["norm"], y * F.silu(zg), cfg.norm_eps, run)
    out = L.wdot("bse,ed->bsd", y.to(cd), p["out_proj"].to(cd))
    return out.to(x.dtype), new_state


def ssm_state_spec(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   n_layers: int | None = None,
                   device: str | torch.device = "meta") -> SSMState:
    """Zero decode states stacked over layers, on ``device`` (``meta``,
    the default: the shapes alone)."""
    L_ = n_layers if n_layers is not None else cfg.n_layers
    conv_ch = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    return SSMState(
        conv=torch.zeros((L_, batch, cfg.ssm_conv_width - 1, conv_ch),
                         dtype=dtype, device=device),
        ssd=torch.zeros((L_, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=dtype, device=device))


# --------------------------------------------------------------------------
# Full Mamba-2 LM
# --------------------------------------------------------------------------

def lm_spec(cfg: ModelConfig) -> Params:
    return {
        "embed": L.embed_spec(cfg),
        "blocks": stack_layers(
            lambda: {"ln": L.rmsnorm_spec(cfg.d_model), "ssm": ssm_spec(cfg)},
            cfg.n_layers),
        "ln_f": L.rmsnorm_spec(cfg.d_model),
    }


def layer_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Matmul FLOPs of one layer outside the scan: in_proj and
    out_proj."""
    T, D = batch * seq, cfg.d_model
    di, G, N, H = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    return (2 * T * D * (2 * di + 2 * G * N + H)   # in_proj
            + 2 * T * di * D)                      # out_proj


def matmul_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Analytic FLOPs of the matmuls of :func:`forward` outside the scan:
    per layer in_proj and out_proj, plus the unembedding.  (At
    ``ssd_impl="kernel"`` the scan is one kernel record; at ``"xla"`` its
    einsums add their own products.)"""
    return (cfg.n_layers * layer_flops(cfg, batch, seq)
            + 2 * batch * seq * cfg.d_model * cfg.vocab_padded)


def layer_apply(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                run: RunConfig) -> torch.Tensor:
    """One pre-norm Mamba-2 layer with its residual (the reference's scan
    body, between its two activation constraints)."""
    x = constrain(x, run, "batch", "seq", None)
    y, _ = ssm_apply(lp["ssm"], L.rmsnorm_apply(lp["ln"], x, cfg.norm_eps,
                                                run), cfg, run)
    return constrain(x + y, run, "batch", "seq", None)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            run: RunConfig) -> torch.Tensor:
    """Full-sequence forward (chunked SSD) → logits (B, S, vocab_padded);
    the reference's auxiliary loss is 0 for this family."""
    x = L.embed_apply(params["embed"], tokens, run)
    for lp in unstack_layers(params["blocks"]):
        x = L.remat_apply(layer_apply, run, lp, x, cfg, run)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    return L.unembed_apply(params["embed"], x, run)


def init_state(cfg: ModelConfig, batch: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "meta") -> SSMState:
    return ssm_state_spec(cfg, batch, dtype, device=device)


def decode_step(params: Params, tokens: torch.Tensor, state: SSMState,
                cfg: ModelConfig, run: RunConfig
                ) -> tuple[torch.Tensor, SSMState]:
    """One-token decode: the O(1) recurrent step of every layer → (logits
    (B, 1, vocab_padded), the new state).  tokens: (B, 1)."""
    x = L.embed_apply(params["embed"], tokens, run)
    convs, ssds = [], []
    for lp, conv, ssd in zip(unstack_layers(params["blocks"]), state.conv,
                             state.ssd):
        x, st = layer_step(lp, x, SSMState(conv, ssd), cfg, run)
        convs.append(st.conv)
        ssds.append(st.ssd)
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
    logits = L.unembed_apply(params["embed"], x, run)
    return logits, SSMState(conv=torch.stack(convs), ssd=torch.stack(ssds))


def layer_step(lp: Params, x: torch.Tensor, state: SSMState,
               cfg: ModelConfig, run: RunConfig
               ) -> tuple[torch.Tensor, SSMState]:
    """:func:`layer_apply`'s decode step: (x + y, the layer's new state)."""
    y, st = ssm_apply(lp["ssm"], L.rmsnorm_apply(lp["ln"], x, cfg.norm_eps,
                                                 run), cfg, run, state=state)
    return x + y, st
