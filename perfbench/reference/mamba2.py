"""Plain reference of the Mamba-2 language model (arXiv:2405.21060): pre-norm
layers of in_proj, a causal depthwise conv with SiLU, the SSD scan with
a skip, the gated RMSNorm and out_proj, then the final norm, the tied
unembedding and the token cross-entropy, all in float32.

One group of B and C (``ssm_n_groups`` 1).  The in_proj output splits
into (z, x, B, C, dt) of widths (d_inner, d_inner, N, N, heads); dt is
``softplus(dt + dt_bias)``, the per-step log-decay ``−exp(A_log)·dt``,
and the scan's input is x·dt.  The scan is the chunked dual form,
written here from the recurrence

    s_t = exp(a_t)·s_{t−1} + B_t ⊗ x_t,   y_t = C_t · s_t

(inside a chunk the masked quadratic form, across chunks the carried
state).  The gate is ``rmsnorm(y · silu(z))``.  Leaves are stacked over
the layers; each layer is recomputed in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import yardstick
from perfbench.reference.common import Products, cross_entropy, rmsnorm
from perfbench.reference.dense import padded_vocab


def _dims(m: dict) -> tuple[int, int, int, int, int, int]:
    D = m["d_model"]
    di = m["ssm_expand"] * D
    return D, di, m["ssm_state"], di // m["ssm_head_dim"], \
        m["ssm_head_dim"], m["ssm_conv_width"]


def layout(m: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(path, shape, init, std) of every leaf.  ``a_log`` draws
    log U(1, 16) and ``dt_bias`` the inverse softplus of a dt drawn
    log-uniform in [1e-3, 1e-1], as the published model initialises
    them."""
    if m["ssm_n_groups"] != 1:
        raise ValueError("the reference takes one group of B and C")
    L = m["n_layers"]
    D, di, N, H, _, W = _dims(m)
    conv = di + 2 * N
    out = [("embed/tokens", (padded_vocab(m["vocab_size"]), D), "normal",
            0.02)]
    if not m["tie_embeddings"]:
        out.append(("embed/unembed", (D, padded_vocab(m["vocab_size"])),
                    "normal", D ** -0.5))
    out += [
        ("blocks/ln/scale", (L, D), "ones", 0.0),
        ("blocks/ssm/A_log", (L, H), "a_log", 0.0),
        ("blocks/ssm/D_skip", (L, H), "ones", 0.0),
        ("blocks/ssm/conv_b", (L, conv), "zeros", 0.0),
        ("blocks/ssm/conv_w", (L, W, conv), "normal", W ** -0.5),
        ("blocks/ssm/dt_bias", (L, H), "dt_bias", 0.0),
        ("blocks/ssm/in_proj", (L, D, 2 * di + 2 * N + H), "normal",
         D ** -0.5),
        ("blocks/ssm/norm/scale", (L, di), "ones", 0.0),
        ("blocks/ssm/out_proj", (L, di, D), "normal", di ** -0.5),
        ("ln_f/scale", (D,), "ones", 0.0),
    ]
    return out


def weights_per_token(m: dict) -> int:
    """Weights a token multiplies: per layer in_proj, the depthwise conv
    and out_proj, and the unembedding over the real vocabulary."""
    D, di, N, H, _, W = _dims(m)
    g = m["ssm_n_groups"]
    per_layer = D * (2 * di + 2 * g * N + H) + W * (di + 2 * g * N) + di * D
    return m["n_layers"] * per_layer + D * m["vocab_size"]


def model_flops(m: dict, batch: int, seq: int) -> float:
    """FLOPs of one train step (``yardstick.train_flops``): the weights,
    and each layer's SSD scan at its needed FLOPs forward."""
    _, _, N, H, P, _ = _dims(m)
    scan = yardstick.ssd_needed_flops(batch, H, seq, P, N,
                                      min(m["ssm_chunk"], seq))
    return yardstick.train_flops(batch * seq, weights_per_token(m),
                                 m["n_layers"] * scan)


def ssd(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """y (B, S, H, P) of the scan from a zero state: x (B, S, H, P), the
    log-decay a (B, S, H) ≤ 0, Bm and Cm (B, S, N)."""
    b, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // chunk
    x = x.reshape(b, nc, chunk, H, P)
    a = a.reshape(b, nc, chunk, H)
    Bm = Bm.reshape(b, nc, chunk, N)
    Cm = Cm.reshape(b, nc, chunk, N)
    cum = a.cumsum(dim=2)                                   # (b, c, q, h)
    # inside a chunk: y_i = Σ_{j ≤ i} exp(cum_i − cum_j)·(C_i·B_j)·x_j
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    gap = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b, c, i, j, h)
    decay = gap.masked_fill(~causal, float("-inf")).exp()
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, x)
    # each chunk's own state: Σ_j exp(cum_last − cum_j)·B_j ⊗ x_j
    to_end = (cum[:, :, -1:, :] - cum).exp()
    inc = torch.einsum("bcqn,bcqhp->bchpn", Bm, x * to_end[..., None])
    # the state entering each chunk, carried across chunks
    s = x.new_zeros(b, H, P, N)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * cum[:, c, -1, :].exp()[:, :, None, None] + inc[:, c]
    prev = torch.stack(entering, dim=1)                     # (b, c, h, p, n)
    y = y + torch.einsum("bcqn,bchpn->bcqhp", Cm, prev) * \
        cum.exp()[..., None]
    return y.reshape(b, S, H, P)


def _layer(x, ln, A_log, D_skip, conv_b, conv_w, dt_bias, in_proj,
           norm_scale, out_proj, *, m: dict, mm: Products):
    b, S, _ = x.shape
    D, di, N, H, P, W = _dims(m)
    eps = m["norm_eps"]
    z = mm("bsd,de->bse", mm.act(rmsnorm(x, ln, eps)), in_proj)
    gate, xi, Bm, Cm, dt = torch.split(z, [di, di, N, N, H], dim=-1)
    u = torch.cat([xi, Bm, Cm], dim=-1).transpose(1, 2)    # (b, conv, S)
    u = F.conv1d(u, conv_w.T[:, None, :], conv_b, padding=W - 1,
                 groups=u.shape[1])[..., :S]
    xi, Bm, Cm = torch.split(mm.act(F.silu(u.transpose(1, 2))), [di, N, N],
                             dim=-1)
    dt = torch.logaddexp(dt + dt_bias, torch.zeros((), device=x.device))
    xh = mm.act(xi.reshape(b, S, H, P) * dt[..., None])
    y = mm.act(ssd(xh, -A_log.exp() * dt, Bm, Cm, min(m["ssm_chunk"], S)))
    y = mm.act(y + xh * D_skip[:, None]).reshape(b, S, di)
    y = mm.act(rmsnorm(mm.act(y * F.silu(gate)), norm_scale, eps))
    return mm.act(x + mm("bse,ed->bsd", y, out_proj))


_LAYER_LEAVES = ("blocks/ln/scale", "blocks/ssm/A_log", "blocks/ssm/D_skip",
                 "blocks/ssm/conv_b", "blocks/ssm/conv_w",
                 "blocks/ssm/dt_bias", "blocks/ssm/in_proj",
                 "blocks/ssm/norm/scale", "blocks/ssm/out_proj")


def loss(params: dict[str, torch.Tensor], batch: dict, m: dict,
         mm: Products) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (tokens, targets
    (B, S))."""
    table = params["embed/tokens"]
    x = mm.act(table[batch["tokens"].long()])
    per_layer = zip(*(torch.unbind(params[k]) for k in _LAYER_LEAVES))
    for leaves in per_layer:
        x = checkpoint(_layer, x, *leaves, m=m, mm=mm, use_reentrant=False)
    x = mm.act(rmsnorm(x, params["ln_f/scale"], m["norm_eps"]))
    w = params["embed/unembed"] if "embed/unembed" in params else table.T
    return cross_entropy(mm("bsd,dv->bsv", x, w), batch["targets"],
                         m["vocab_size"])
