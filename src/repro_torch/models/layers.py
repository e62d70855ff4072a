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
from repro_torch.distributed.sharding import (constrain, gather_for_use,
                                              gather_seq, is_dtensor,
                                              whole_seq_grad)
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
    the ``remat="dots"`` policy.  On a mesh the weight's FSDP shards and
    the activation's sequence shard are gathered first
    (:func:`sharding.gather_for_use`, :func:`sharding.gather_seq`)."""
    if w.dim() not in (2, 3):
        raise ValueError(f"wdot takes a 2-D or 3-D weight, got "
                         f"{tuple(w.shape)}")
    w, x = gather_for_use(w), gather_seq(x)
    _WEIGHT.on = True
    try:
        return whole_seq_grad(torch.einsum(eq, x, w))
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
    heads = _LocalHeads(q, H, K) if is_dtensor(q) else None
    if (heads is not None and kv_cache is not None and S == 1
            and heads.seq_sharded(kv_cache[0])):
        # a decode step against a cache sharded on its sequence
        out, new_cache = heads.decode_seq_sharded(q, k, v, kv_cache,
                                                  cache_len, sd)
        y = wdot("bshk,hkd->bsd", out, p["wo"].to(cd)).to(x.dtype)
        return y, new_cache
    if heads is not None:
        # a mesh run: the attention math on this rank's query heads
        q, k, v = heads.enter(q, k, v)
        if kv_cache is not None:
            kv_cache = heads.enter_cache(kv_cache)
            cache_len = heads.local_rows(cache_len)
        positions = heads.local_rows(positions)
    Bl = q.shape[0]
    new_cache = None
    if kv_cache is not None:
        idx = (cache_len if cache_len is not None else
               torch.zeros((Bl,), dtype=torch.int32, device=q.device))
        ck, cv = cache_update(kv_cache, k, v, idx)
        new_cache = (ck, cv)
        k, v = ck.to(cd), cv.to(cd)
        if heads is not None:
            k, v = heads.select(k), heads.select(v)
        qg = _group(q, k.shape[2])
        k_pos = torch.arange(ck.shape[1], device=q.device)
        out = _sdpa(qg, k, v, positions, k_pos, causal=False, k_len=idx + 1,
                    stat_dtype=sd)
    else:
        if heads is not None:
            k, v = heads.select(k), heads.select(v)
        qg = _group(q, k.shape[2])
        k_pos = (torch.arange(k.shape[1], device=q.device)
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
    out = out.reshape(*q.shape)
    if heads is not None:
        out = heads.exit(out)
        if new_cache is not None:
            new_cache = tuple(heads.exit_cache(c) for c in new_cache)
    y = wdot("bshk,hkd->bsd", out, p["wo"].to(cd)).to(x.dtype)
    return y if kv_cache is None else (y, new_cache)


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q (B, S, H, hd) grouped by KV head → (B, S, n_kv, H // n_kv, hd)."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


class _LocalHeads:
    """GQA attention on one rank's query heads, for a run on a mesh.

    q comes out of its projection a DTensor sharded over ``"model"`` on
    its heads (where they divide).  A DTensor placement cannot express
    that shard in the grouped (K, G) layout the attention math takes:
    glm4's 32 query heads on a 16-way axis give each rank 2 heads of one
    of its 2 KV groups, which is neither a shard of K nor of G.  So the
    math runs on local tensors, the Megatron way: q keeps its batch and
    heads shards, K/V (and a decode cache) keep their batch shard and
    are sharded on their heads where ``"model"`` divides them and whole
    otherwise (the redistribution gathers them); each rank picks the KV
    heads its query heads read (:meth:`select`) and runs the same
    attention — einsum, chunked or the flash kernel — on its shard.  The
    output goes back as a DTensor with q's placements.  A whole K/V's
    gradient is a partial sum over the model axis (each rank's heads
    read part of it), which its DTensor placement says, so the backward
    reduces it.  Any other placement is redistributed first."""

    def __init__(self, q: torch.Tensor, n_heads: int, n_kv: int):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = q.device_mesh
        self.mesh, self.H, self.K = mesh, n_heads, n_kv
        self.qpl, self.kvpl, self.kvgrad = [], [], []
        self.rank, self.n = 0, 1
        names = mesh.mesh_dim_names
        self.mi = names.index("model") if "model" in names else None
        for i, name in enumerate(names):
            size = mesh.size(i)
            if name == "model" and size > 1 and n_heads % size == 0:
                self.rank, self.n = mesh.get_local_rank(i), size
                self.qpl.append(Shard(2))
                kv_split = n_kv % size == 0
                self.kvpl.append(Shard(2) if kv_split else Replicate())
                self.kvgrad.append(Shard(2) if kv_split else Partial())
            else:
                pl = q.placements[i]
                b = (Shard(0) if name != "model" and isinstance(pl, Shard)
                     and pl.dim == 0 else Replicate())
                self.qpl.append(b)
                self.kvpl.append(b)
                self.kvgrad.append(b)

    def _local(self, t, pl, grad):
        return t.redistribute(self.mesh, pl).to_local(grad_placements=grad)

    def enter(self, q, k, v):
        """Local q (Bl, S, H/n, hd), k and v (Bl, S, K or K/n, hd)."""
        return (self._local(q, self.qpl, self.qpl),
                self._local(k, self.kvpl, self.kvgrad),
                self._local(v, self.kvpl, self.kvgrad))

    def enter_cache(self, cache):
        return tuple(self._local(c, self.kvpl, self.kvgrad) for c in cache)

    def local_rows(self, t):
        """A fill or position tensor on this rank: a scalar or a (1, 1)
        whole, a per-row (B, ...) one cut to q's batch shard."""
        from torch.distributed.tensor import Replicate, Shard
        if not is_dtensor(t):
            return t
        per_row = t.dim() > 0 and t.shape[0] > 1
        rows = [Shard(0) if per_row and p == Shard(0) else Replicate()
                for p in self.qpl]
        return t.redistribute(self.mesh, rows).to_local()

    def select(self, t):
        """The KV heads this rank's query heads read, of a local K/V
        (Bl, S, K, hd) that holds every KV head; a sharded one as is."""
        if self.n == 1 or self.K % self.n == 0:
            return t
        hl, g = self.H // self.n, self.H // self.K
        lo = self.rank * hl
        if hl % g == 0 or g % hl == 0:
            return t[:, :, lo // g: lo // g + max(hl // g, 1)]
        idx = torch.arange(lo, lo + hl, device=t.device) // g
        return t.index_select(2, idx)

    def seq_sharded(self, cache) -> bool:
        """Is this (B, S, K, hd) cache sharded on its sequence over the
        model axis (its KV heads do not divide it)?"""
        from torch.distributed.tensor import Shard
        return (self.mi is not None and self.K % self.mesh.size(self.mi)
                and cache.placements[self.mi] == Shard(1))

    def decode_seq_sharded(self, q, k, v, cache, fill, stat_dtype):
        """One decode step against a cache whose sequence is sharded over
        the model axis (``sharding.decode_state_shardings``: KV heads
        that do not divide it).  Each rank attends every query head of
        its batch rows to its own sequence shard and the shards combine
        exactly, by their softmax statistics (flash decoding): the
        maximum's all-reduce, then one of the rescaled outputs and one of
        the rescaled sums — (B, H, hd)-sized, where gathering the cache
        would move all of it.  The new token lands in the shard that
        holds its position, by a select over the shard (the reference's
        partitioner makes the same select for a write at a dynamic
        position on a sharded dim).  → (the output (B, 1, H, hd) placed
        as q, the new cache placed as the old)."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        mi, mesh = self.mi, self.mesh
        n, r = mesh.size(mi), mesh.get_local_rank(mi)
        rows = [Replicate() if i == mi else p
                for i, p in enumerate(self.qpl)]
        cpl = [Shard(1) if i == mi else p for i, p in enumerate(rows)]
        ql = q.redistribute(mesh, rows).to_local()           # every head
        kl = k.redistribute(mesh, rows).to_local()
        vl = v.redistribute(mesh, rows).to_local()
        ck, cv = (c.redistribute(mesh, cpl).to_local() for c in cache)
        B, S_l = ck.shape[:2]
        pos = r * S_l + torch.arange(S_l, device=ck.device)
        idx = self.local_rows(fill) if fill is not None else torch.zeros(
            (B,), dtype=torch.int32, device=ck.device)
        if idx.dim() == 0:                       # aligned: the write clamps
            hit = pos == idx.clamp(0, S_l * n - 1)
            valid = pos < idx + 1
            hit4 = hit[None, :, None, None]
        else:                                    # per row: past the end drops
            hit = pos[None, :] == idx[:, None]
            valid = (pos[None, :] < idx[:, None] + 1)[:, None, None, None]
            hit4 = hit[:, :, None, None]
        ck = torch.where(hit4, kl.to(ck.dtype), ck)
        cv = torch.where(hit4, vl.to(cv.dtype), cv)
        cd = ql.dtype
        qg = _group(ql, self.K)                                # (B,1,K,G,hd)
        scores = (torch.einsum("bqkgh,bskh->bkgqs", qg, ck.to(cd))
                  * ql.shape[-1] ** -0.5).to(stat_dtype)
        scores = torch.where(valid, scores, -1e30)
        m = scores.amax(-1, keepdim=True)                      # (B,K,G,1,1)
        w = torch.exp(scores - m)
        total = w.sum(-1, keepdim=True)
        o = torch.einsum("bkgqs,bskh->bqkgh", w.to(cd), cv.to(cd))

        def reduce(t, op):
            part = [Partial(op) if i == mi else p for i, p in enumerate(rows)]
            return self._wrap(t, part, self._global(t, rows)).redistribute(
                mesh, rows).to_local()

        big = reduce(m, "max")
        scale = torch.exp(m - big)                             # (B,K,G,1,1)
        o = reduce(o * scale.permute(0, 3, 1, 2, 4).to(cd), "sum")
        total = reduce(total * scale, "sum")
        out = o / total.permute(0, 3, 1, 2, 4).to(cd)
        hl = self.H // self.n                  # this rank's query heads
        out = out.reshape(B, 1, self.H, -1)[
            :, :, self.rank * hl:(self.rank + 1) * hl]
        new = tuple(self._wrap(c.contiguous(), cpl, self._global(c, cpl))
                    for c in (ck, cv))
        return self.exit(out.contiguous()), new

    def _wrap(self, t, pl, shape):
        from torch.distributed.tensor import DTensor
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t, self.mesh, pl, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def exit(self, out):
        """The local output (Bl, S, H/n, hd) as the whole (B, S, H, hd)."""
        return self._wrap(out, self.qpl, self._global(out, self.qpl))

    def exit_cache(self, c):
        return self._wrap(c, self.kvpl, self._global(c, self.kvpl))

    def _global(self, t, pl):
        from torch.distributed.tensor import Shard
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= self.mesh.size(i)
        return tuple(shape)


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
    """The token embedding gather.  On a mesh it is a vocab-parallel
    lookup (:func:`_vocab_parallel_embed`) for a vocab-sharded table and
    ``F.embedding`` otherwise, whose DTensor rules (and their backwards)
    hold in every torch the port runs on; the fused one-hot gradient is
    a single-device route."""
    fops = _fused(run)
    if is_dtensor(p["tokens"]):
        table = gather_for_use(p["tokens"].to(run.compute_dtype))
        x = _vocab_parallel_embed(table, tokens)
    elif fops is not None and fops.use_embed(run, p["tokens"], tokens,
                                             run.compute_dtype):
        # same gather forward; the backward is one onehotᵀ @ g matmul
        x = fops.embed_with_onehot_grad(p["tokens"], tokens,
                                        run.compute_dtype)
    else:
        x = p["tokens"].to(run.compute_dtype)[tokens]
    return constrain(x, run, "batch", "seq", None)


def _vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor
                          ) -> torch.Tensor:
    """``table[tokens]`` for a DTensor table: where ``"model"`` shards the
    vocab, Megatron's vocab-parallel lookup — each rank looks up the
    tokens its rows hold (zeros elsewhere), a partial sum over the model
    axis that the next constraint reduces; the table's gradient is the
    rank's rows (summed over the data axes the tokens are sharded on).
    Otherwise ``F.embedding`` on the DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    if mi is None or table.placements[mi] != Shard(0):
        return F.embedding(tokens, table)
    tok_pl = [Replicate() if i == mi else p
              for i, p in enumerate(tokens.placements)]
    tok = tokens.redistribute(mesh, tok_pl).to_local()
    grad_pl = [Shard(0) if i == mi else
               (Partial() if p == Shard(0) else Replicate())
               for i, p in enumerate(tok_pl)]
    local = table.to_local(grad_placements=grad_pl)
    n = local.shape[0]
    lo = mesh.get_local_rank(mi) * n
    hit = (tok >= lo) & (tok < lo + n)
    x = F.embedding(torch.where(hit, tok - lo, 0), local) \
        * hit[..., None].to(local.dtype)
    out_pl = [Partial() if i == mi else p for i, p in enumerate(tok_pl)]
    shape = (*tokens.shape, table.shape[1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(x, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def unembed_apply(p: Params, x: torch.Tensor, run: RunConfig
                  ) -> torch.Tensor:
    cd = run.compute_dtype
    w = p.get("unembed")
    if w is None:
        w = p["tokens"].T
    logits = whole_seq_grad(torch.einsum(
        "bsd,dv->bsv", gather_seq(x.to(cd)), gather_for_use(w.to(cd))))
    return constrain(logits, run, "batch", "seq", "vocab")
