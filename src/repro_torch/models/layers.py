"""Core transformer layers (port of ``repro.models.layers``): norms, RoPE,
GQA attention, the MLP (gated: swiglu, geglu; ungated: gelu, relu2),
embedding and unembedding, and the per-block ``remat``.

Plain functions on tensors: ``*_spec(cfg)`` returns a :class:`P` tree and
``*_apply(params, x, ...)`` is the forward.  Matmuls run in
``RunConfig.compute_dtype``; norms and softmax statistics accumulate in
fp32.  Weights are cast to the compute dtype where they are used, one
layer at a time, as the reference does (casting the whole fp32 tree at
once would hold a second copy of every weight).

The norms, the MLP epilogue and the embedding take a ``run``: with
``fusion="static"`` an eligible call routes through the fused kernels
(``repro_torch.kernels.fused.ops``) at the reference's call sites, and
with ``"auto"`` an eligible call whose measured dispatch verdict is
``fused``; any other keeps the plain math below.  Attention follows
``run.attn_impl``: ``"flash"`` takes the flash-attention kernel,
``"chunked"`` the query-chunked path (or, under fusion, the kernel where
the shape is eligible), anything else the einsum path.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.fused.swiglu import gelu_tanh
from repro_torch.models.params import P

Params = Any


# --------------------------------------------------------------------------
# Products against a weight, and remat
# --------------------------------------------------------------------------

_WEIGHT = threading.local()


def wdot(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` where ``w`` is a 2-D or 3-D weight:
    the products with no batch dims of the reference's
    ``checkpoint_dots_with_no_batch_dims``.  ``torch.einsum`` lowers
    these and the batched QKᵀ / PV / SSD products alike to ``bmm``, so
    the product is told apart by its operand: this call marks it (on the
    calling thread, which is the autograd thread during a recompute) for
    the ``remat="dots"`` policy."""
    if w.dim() not in (2, 3):
        raise ValueError(f"wdot takes a 2-D or 3-D weight, got "
                         f"{tuple(w.shape)}")
    _WEIGHT.on = True
    try:
        return torch.einsum(eq, x, w)
    finally:
        _WEIGHT.on = False


_PRODUCTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                       torch.ops.aten.addmm.default,
                       torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the products against a weight (:func:`wdot`), recompute every
    other op: the batched QKᵀ and PV, softmax, norms, acts, RoPE, the SSD
    scan's einsums and every ``repro_torch::`` custom op's output."""
    if op in _PRODUCTS and getattr(_WEIGHT, "on", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXTS = functools.partial(create_selective_checkpoint_contexts,
                                   _dots_policy)


def remat_apply(fn: Callable, run: RunConfig, *args) -> Any:
    """``fn(*args)`` under ``run.remat`` (the reference's ``_remat`` around
    a scanned layer body): ``"full"`` keeps only the inputs for the
    backward and recomputes the rest; ``"dots"`` also keeps the outputs
    of the products against a weight — the q/k/v/o projections, the MLP
    products, the SSM's in_proj and out_proj — and recomputes the rest;
    ``"none"`` keeps whatever autograd saves.  Non-reentrant
    ``torch.utils.checkpoint``: its recompute stops once the tensors the
    backward needs are back, so a block's last product (whose output no
    backward reads) is not recomputed under ``"full"``, as XLA drops it
    from the reference's rematerialised program."""
    if run.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if run.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_DOTS_CONTEXTS)
    return fn(*args)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def _fused(run):
    from repro_torch.kernels.fused import ops as fops
    return fops if fops.fusion_enabled(run) else None


def rmsnorm_spec(d: int) -> Params:
    return {"scale": P((d,), ("embed",), "ones")}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5,
                  run: RunConfig | None = None) -> torch.Tensor:
    fops = _fused(run)
    if fops is not None and fops.use_norm(run, x, p["scale"]):
        return fops.rmsnorm(x, p["scale"], eps=eps)
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(dt)


def rmsnorm_residual_apply(p: Params, x: torch.Tensor, h: torch.Tensor,
                           eps: float = 1e-5, run: RunConfig | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + h, rmsnorm(x + h)) — the pre-norm block's residual seam.  The
    fused route also needs h in x's dtype (the kernel adds in x's
    dtype)."""
    fops = _fused(run)
    if fops is not None and x.shape == h.shape and x.dtype == h.dtype \
            and fops.use_norm(run, x, p["scale"], kind="rmsnorm_residual"):
        return fops.rmsnorm_residual(x, h, p["scale"], eps=eps)
    r = x + h
    return r, rmsnorm_apply(p, r, eps)


def layernorm_spec(d: int) -> Params:
    return {"scale": P((d,), ("embed",), "ones"),
            "bias": P((d,), ("embed",), "zeros")}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5,
                    run: RunConfig | None = None) -> torch.Tensor:
    """LayerNorm with the population variance (the reference's
    ``jnp.var``; ``torch.var`` defaults to ``correction=1``)."""
    fops = _fused(run)
    if fops is not None and fops.use_norm(run, x, p["scale"], p["bias"],
                                          kind="layernorm"):
        return fops.layernorm(x, p["scale"], p["bias"], eps=eps)
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """RoPE over the trailing head_dim of ``x`` (..., S, H, hd), in the
    rotate-half form (halves split and concatenated, not interleaved)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq                   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------

def attention_spec(cfg: ModelConfig) -> Params:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": P((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((D, K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((D, K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, D), ("heads", "head_dim", "embed")),
    }


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          k_len: torch.Tensor | None = None,
          stat_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Grouped scaled-dot-product attention.

    q: (B, Sq, K, G, hd) — query heads grouped by their KV head.
    k/v: (B, Sk, K, hd).  ``k_len`` (decode: the cache's fill) masks the
    keys at positions ≥ it: a scalar for an aligned batch, or (B,) one a
    row.  Masked scores are -1e30 (not -inf, as the reference), softmax
    statistics in ``stat_dtype``.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    scores = scores.to(stat_dtype)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]                 # (Sq, Sk)
        scores = torch.where(mask, scores, -1e30)
    if k_len is not None:                                       # cache fill
        if k_len.dim() == 0:                                    # aligned batch
            valid = k_pos < k_len                               # (Sk,)
        else:
            valid = (k_pos[None, :] < k_len[:, None])[:, None, None, None]
        scores = torch.where(valid, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                  chunk: int, stat_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """Query-chunked attention: O(chunk × Sk) live scores.

    Each chunk runs under ``checkpoint`` (the reference's
    ``jax.checkpoint`` over a ``scan``): only the chunk outputs
    (B, chunk, K, G, hd) survive to the backward pass, and the score and
    softmax matrices are recomputed there.
    """
    Sq = q.shape[1]
    outs = [checkpoint(_sdpa, q[:, i:i + chunk], k, v, q_pos[i:i + chunk],
                       k_pos, causal, None, stat_dtype, use_reentrant=False)
            for i in range(0, Sq - Sq % chunk, chunk)]
    return torch.cat(outs, dim=1)


def _flash(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return fa_ops.flash_attention_gqa(qg, k, v)


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    run: RunConfig, positions: torch.Tensor | None = None,
                    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                    cache_len: torch.Tensor | None = None,
                    causal: bool = True,
                    memory: torch.Tensor | None = None):
    """GQA attention, lowered by ``run.attn_impl`` → y: causal
    self-attention by default; ``causal=False`` unmasked; with ``memory``
    (B, Sm, D) cross-attention, the reference's: K/V are projected from
    ``memory``, neither q nor k is roped, the keys sit at ``arange(Sm)``
    and nothing is masked.  ``"flash"`` takes the kernel only for causal
    self-attention, as the reference's (its kernel is causal); anything
    else runs the plain math of the route.

    With a ``kv_cache`` (decode) → (y, new_kv_cache): the new K/V land in
    a copy of the cache at ``cache_len`` (zeros when None) and the queries
    attend the cache's first ``cache_len + 1`` rows (:func:`cache_update`).
    """
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    cd = run.compute_dtype
    sd = torch.float32 if run.softmax_f32 else cd
    xc = x.to(cd)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    kv_src = xc if memory is None else memory.to(cd)
    q = wdot("bsd,dhk->bshk", xc, p["wq"].to(cd))
    k = wdot("bsd,dhk->bshk", kv_src, p["wk"].to(cd))
    v = wdot("bsd,dhk->bshk", kv_src, p["wv"].to(cd))
    if memory is None:                                 # self-attn: RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    qg = q.reshape(B, S, K, G, hd)
    new_cache = None
    if kv_cache is not None:
        idx = (cache_len if cache_len is not None else
               torch.zeros((B,), dtype=torch.int32, device=x.device))
        ck, cv = cache_update(kv_cache, k, v, idx)
        new_cache = (ck, cv)
        k_pos = torch.arange(ck.shape[1], device=x.device)
        out = _sdpa(qg, ck.to(cd), cv.to(cd), positions, k_pos, causal=False,
                    k_len=idx + 1, stat_dtype=sd)
    else:
        k_pos = (torch.arange(k.shape[1], device=x.device)
                 if memory is not None else positions)
        masked = causal and memory is None
        if run.attn_impl == "flash" and masked:
            out = _flash(qg, k, v)
        elif (run.attn_impl == "chunked" and S > run.attn_chunk
                and S % run.attn_chunk == 0):
            # under fusion the chunked path takes the flash kernel where
            # the shape is eligible (causal self-attention): the same
            # score math, no (chunk × S) matrices
            fops = _fused(run)
            if fops is not None and fops.use_flash_from_chunked(
                    run, qg.shape, k.shape, qg.dtype, causal=causal,
                    has_memory=memory is not None, has_cache=False,
                    softmax_f32=run.softmax_f32, chunk=run.attn_chunk,
                    device=qg.device):
                out = _flash(qg, k, v)
            else:
                out = _sdpa_chunked(qg, k, v, positions, k_pos, masked,
                                    run.attn_chunk, stat_dtype=sd)
        else:
            out = _sdpa(qg, k, v, positions, k_pos, causal=masked,
                        stat_dtype=sd)
    out = out.reshape(B, S, H, hd)
    y = wdot("bshk,hkd->bsd", out, p["wo"].to(cd)).to(x.dtype)
    return y if kv_cache is None else (y, new_cache)


def cache_update(kv_cache: tuple[torch.Tensor, torch.Tensor],
                 k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The caches (B, S_max, K, hd) with the new k/v (B, S, K, hd) written
    at fill position ``idx``, out of place, as the reference writes them:

    * one token at a scalar ``idx`` (an aligned batch): its
      ``dynamic_update_slice``, which clamps the start into the cache — a
      full cache has its last row overwritten;
    * one token at per-row ``idx`` (B,): its scatter with
      ``mode="drop"`` — a row whose ``idx`` is past the cache is left as
      it was;
    * several tokens: its one-hot blend ``ck·(1 - oh) + oh·k`` over the
      cache axis (an ``idx`` outside the cache writes nothing).
    """
    ck, cv = kv_cache
    B, S = k.shape[:2]
    S_max = ck.shape[1]
    if S == 1 and idx.dim() == 0:
        at = idx.clamp(0, S_max - 1).reshape(1).long()
        return (ck.index_copy(1, at, k.to(ck.dtype)),
                cv.index_copy(1, at, v.to(cv.dtype)))
    if S == 1:
        rows = torch.arange(B, device=ck.device)
        # a dropped row rewrites its own row 0 with what it holds (a
        # negative idx counts from the end, as the reference's does)
        ok = idx < S_max
        at = torch.where(ok, idx, 0)
        return tuple(
            c.index_put((rows, at), torch.where(
                ok[:, None, None], n[:, 0].to(c.dtype), c[rows, at]))
            for c, n in ((ck, k), (cv, v)))
    oh = (idx[..., None] == torch.arange(S_max, device=ck.device)
          ).to(ck.dtype)[:, :, None, None]
    return (ck * (1 - oh) + oh * k.to(ck.dtype),
            cv * (1 - oh) + oh * v.to(cv.dtype))


def kv_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  n_layers: int | None = None,
                  device: str | torch.device = "meta"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero K and V caches (L, batch, max_len, K, hd) on ``device``; on
    ``meta`` (the default) they stand for the shapes and allocate
    nothing, as the reference's abstract ``ShapeDtypeStruct`` specs."""
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

#: the MLP activations: gated (``w_gate`` and ``w_up``) and ungated
#: (``w_up`` alone)
GATED_ACTS = ("swiglu", "geglu")
UNGATED_ACTS = ("gelu", "relu2")


def mlp_spec(cfg: ModelConfig, d_ff: int | None = None) -> Params:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    if cfg.act in GATED_ACTS:
        return {"w_gate": P((D, Fd), ("embed", "ffn")),
                "w_up": P((D, Fd), ("embed", "ffn")),
                "w_down": P((Fd, D), ("ffn", "embed"))}
    return {"w_up": P((D, Fd), ("embed", "ffn")),
            "w_down": P((Fd, D), ("ffn", "embed"))}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              run: RunConfig) -> torch.Tensor:
    """The MLP by ``cfg.act``:

    * ``swiglu``: silu(x·W_gate) · (x·W_up) · W_down;
    * ``geglu``: the same with the tanh-approximate gelu — the one act
      that takes ``fused_swiglu``'s gelu route;
    * ``gelu``: gelu(x·W_up) · W_down, ungated and tanh-approximate
      (``jax.nn.gelu``'s default, not ``F.gelu``'s);
    * ``relu2``: relu(x·W_up)² · W_down, ungated.

    The ungated acts have no kernel (nor does the reference)."""
    cd = run.compute_dtype
    xc = x.to(cd)
    if cfg.act in GATED_ACTS:
        g = wdot("bsd,df->bsf", xc, p["w_gate"].to(cd))
        u = wdot("bsd,df->bsf", xc, p["w_up"].to(cd))
        act = "silu" if cfg.act == "swiglu" else "gelu"
        fops = _fused(run)
        if fops is not None and fops.use_swiglu(run, g, u, act=act):
            h = fops.swiglu(g, u, act=act)
        else:
            h = (F.silu(g) if act == "silu" else gelu_tanh(g)) * u
    elif cfg.act in UNGATED_ACTS:
        h = wdot("bsd,df->bsf", xc, p["w_up"].to(cd))
        h = gelu_tanh(h) if cfg.act == "gelu" else torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown act {cfg.act!r}; known: "
                         f"{GATED_ACTS + UNGATED_ACTS}")
    y = wdot("bsf,fd->bsd", h, p["w_down"].to(cd))
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embed_spec(cfg: ModelConfig) -> Params:
    V = cfg.vocab_padded
    out = {"tokens": P((V, cfg.d_model), ("vocab", "embed"), "small_normal")}
    if not cfg.tie_embeddings:
        out["unembed"] = P((cfg.d_model, V), ("embed", "vocab"))
    return out


def embed_apply(p: Params, tokens: torch.Tensor, run: RunConfig
                ) -> torch.Tensor:
    fops = _fused(run)
    if fops is not None and fops.use_embed(run, p["tokens"], tokens,
                                           run.compute_dtype):
        # same gather forward; the backward is one onehotᵀ @ g matmul
        return fops.embed_with_onehot_grad(p["tokens"], tokens,
                                           run.compute_dtype)
    return p["tokens"].to(run.compute_dtype)[tokens]


def unembed_apply(p: Params, x: torch.Tensor, run: RunConfig
                  ) -> torch.Tensor:
    cd = run.compute_dtype
    w = p.get("unembed")
    if w is None:
        w = p["tokens"].T
    return torch.einsum("bsd,dv->bsv", x.to(cd), w.to(cd))
