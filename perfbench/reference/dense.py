"""Plain reference of the dense decoder: pre-norm blocks of grouped-query
attention with rotary positions and a SwiGLU MLP, RMSNorm throughout,
an untied or tied unembedding and the token cross-entropy, all in
float32.

Leaves are stacked over the layers (a leading ``n_layers`` axis) in the
layouts the program keeps: ``wq`` (D, H, hd), ``wk`` / ``wv`` (D, KV,
hd), ``wo`` (H, hd, D), the MLP's (D, F) and (F, D), the embedding
(V′, D) and unembedding (D, V′) with V′ the vocabulary padded to a
multiple of 128 (logits past the vocabulary are dropped before the
loss).  Rotary positions rotate the two halves of each head
(``rotate-half``, base ``rope_theta``) over the whole head.  Each layer
is recomputed in the backward (``torch.utils.checkpoint``) so that a
full-width step fits beside nothing else.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import yardstick
from perfbench.reference.common import Products, cross_entropy, rmsnorm


def padded_vocab(v: int) -> int:
    return (v + 127) // 128 * 128


def layout(m: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(path, shape, init, std) of every leaf; ``init`` is ``normal``
    (with ``std``), ``ones`` or ``zeros``."""
    L, D, H, K, hd, Fd = (m["n_layers"], m["d_model"], m["n_heads"],
                          m["n_kv_heads"], m["head_dim"], m["d_ff"])
    V = padded_vocab(m["vocab_size"])
    out = [("embed/tokens", (V, D), "normal", 0.02)]
    if not m["tie_embeddings"]:
        out.append(("embed/unembed", (D, V), "normal", D ** -0.5))
    out += [
        ("blocks/attn/wq", (L, D, H, hd), "normal", D ** -0.5),
        ("blocks/attn/wk", (L, D, K, hd), "normal", D ** -0.5),
        ("blocks/attn/wv", (L, D, K, hd), "normal", D ** -0.5),
        ("blocks/attn/wo", (L, H, hd, D), "normal", (H * hd) ** -0.5),
        ("blocks/ln_attn/scale", (L, D), "ones", 0.0),
        ("blocks/ln_mlp/scale", (L, D), "ones", 0.0),
        ("blocks/mlp/w_down", (L, Fd, D), "normal", Fd ** -0.5),
        ("blocks/mlp/w_gate", (L, D, Fd), "normal", D ** -0.5),
        ("blocks/mlp/w_up", (L, D, Fd), "normal", D ** -0.5),
        ("ln_f/scale", (D,), "ones", 0.0),
    ]
    return out


def weights_per_token(m: dict) -> int:
    """Weights a token multiplies: per layer wq, wk, wv, wo and the gated
    MLP's three matrices, and the unembedding over the real vocabulary.
    The embedding lookup and the norm scales multiply nothing in a
    product and are left out."""
    d, h, kv, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       m["head_dim"], m["d_ff"])
    per_layer = 2 * d * h * hd + 2 * d * kv * hd + 3 * d * f
    return m["n_layers"] * per_layer + d * m["vocab_size"]


def model_flops(m: dict, batch: int, seq: int) -> float:
    """FLOPs of one train step (``yardstick.train_flops``): the weights,
    and each layer's causal attention, 2·B·H·S²·hd forward."""
    attn = yardstick.flash_flops(batch, m["n_heads"], seq, m["head_dim"])
    return yardstick.train_flops(batch * seq, weights_per_token(m),
                                 m["n_layers"] * attn)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate each head's two halves by position · theta^(−i/half);
    x (B, S, heads, hd)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _block(x, wq, wk, wv, wo, ln_attn, ln_mlp, w_gate, w_up, w_down, *,
           m: dict, mm: Products):
    B, S, _ = x.shape
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    h = mm.act(rmsnorm(x, ln_attn, eps))
    q = _rope(mm("bsd,dhk->bshk", h, wq), m["rope_theta"])
    k = _rope(mm("bsd,dhk->bshk", h, wk), m["rope_theta"])
    v = mm("bsd,dhk->bshk", h, wv)
    q = q.reshape(B, S, K, H // K, hd)
    s = mm("bqkgh,bskh->bkgqs", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm("bkgqs,bskh->bqkgh", w, v).reshape(B, S, H, hd)
    x = mm.act(x + mm("bshk,hkd->bsd", o, wo))
    h = mm.act(rmsnorm(x, ln_mlp, eps))
    a = F.silu(mm("bsd,df->bsf", h, w_gate)) * mm("bsd,df->bsf", h, w_up)
    return mm.act(x + mm("bsf,fd->bsd", mm.act(a), w_down))


_BLOCK_LEAVES = ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
                 "blocks/attn/wo", "blocks/ln_attn/scale",
                 "blocks/ln_mlp/scale", "blocks/mlp/w_gate",
                 "blocks/mlp/w_up", "blocks/mlp/w_down")


def loss(params: dict[str, torch.Tensor], batch: dict, m: dict,
         mm: Products) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (tokens, targets
    (B, S))."""
    table = params["embed/tokens"]
    x = mm.act(table[batch["tokens"].long()])
    per_layer = zip(*(torch.unbind(params[k]) for k in _BLOCK_LEAVES))
    for leaves in per_layer:
        x = checkpoint(_block, x, *leaves, m=m, mm=mm, use_reentrant=False)
    x = mm.act(rmsnorm(x, params["ln_f/scale"], m["norm_eps"]))
    w = params["embed/unembed"] if "embed/unembed" in params else table.T
    return cross_entropy(mm("bsd,dv->bsv", x, w), batch["targets"],
                         m["vocab_size"])
