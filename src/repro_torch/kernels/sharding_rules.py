"""DTensor sharding strategies of the ``repro_torch::`` kernel ops.

A ``torch.library.custom_op`` called on DTensors needs a rule saying on
which placements it may run; with one, DTensor redistributes the inputs
to the cheapest acceptable placement and calls the op — the same
hand-written kernel (its plain version on the host) — on each rank's
local shards.  Each rule shards only where the kernel's math is
independent along that dim, and always allows the all-replicated case:

* ``rmsnorm`` / ``rmsnorm_residual`` / ``layernorm`` (rows, d): rows;
  the normalised dim and its scale (and bias) whole;
* ``swiglu`` (rows, d_ff): rows, or columns (elementwise: the ffn shard
  of tensor parallelism stays where it is);
* ``flash_attention`` (q (B, S, K, G, hd), k / v (B, Sk, K, hd); out
  like q and lse (B, K, G, S)): batch, KV heads (q's K with k and v), or
  query groups (q's G, k and v whole); sequence and head_dim whole.  The models' GQA attention on a
  mesh runs the kernel on local heads itself (``layers._LocalHeads``),
  because a heads shard that splits the (K, G) grouping is no DTensor
  placement; the rule serves direct calls;
* ``ssd_scan`` (xh (B, S, H, P), a (B, S, H), B / C (B, S, N)): batch, or
  heads with B and C whole;
* ``aten.flip`` too, which older torch leaves without a rule: any dim
  it does not flip;
* the AdamW group (``adamw_multi_`` / ``adamw_multi``): elementwise, and
  its leaves are lists; ``train.optim.adamw_update`` runs it on each
  leaf's local shard instead of on DTensors.

:func:`register` is idempotent and imports DTensor; ``sharding``
calls it before it makes a DTensor.
"""

from __future__ import annotations

_DONE = False


def register() -> None:
    global _DONE
    if _DONE:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    # the ops exist once their modules are imported
    from repro_torch.kernels.flash_attention import ops as _fa  # noqa: F401
    from repro_torch.kernels.fused import ops as _fo  # noqa: F401
    from repro_torch.kernels.ssd_scan import ops as _so  # noqa: F401

    ops = torch.ops.repro_torch
    R, S0 = Replicate(), Shard(0)

    @register_sharding(ops.rmsnorm.default)
    def _rmsnorm(x, scale, eps, out_dtype):
        return [([S0], [S0, R, None, None]), ([R], [R, R, None, None])]

    @register_sharding(ops.rmsnorm_residual.default)
    def _rmsnorm_residual(x, h, scale, eps, out_dtype):
        return [([S0, S0], [S0, S0, R, None, None]),
                ([R, R], [R, R, R, None, None])]

    @register_sharding(ops.layernorm.default)
    def _layernorm(x, scale, bias, eps, out_dtype):
        return [([S0], [S0, R, R, None, None]),
                ([R], [R, R, R, None, None])]

    @register_sharding(ops.swiglu.default)
    def _swiglu(gate, up, act, out_dtype):
        S1 = Shard(1)
        return [([S0], [S0, S0, None, None]), ([S1], [S1, S1, None, None]),
                ([R], [R, R, None, None])]

    @register_sharding(ops.flash_attention.default)
    def _flash(q, k, v, causal):
        # outputs: o like q, lse (B, K, G, S)
        S1, S2, S3 = Shard(1), Shard(2), Shard(3)
        return [([S0, S0], [S0, S0, S0, None]),
                ([S2, S1], [S2, S2, S2, None]),
                ([S3, S2], [S3, R, R, None]), ([R, R], [R, R, R, None])]

    @register_sharding(ops.ssd_scan.default)
    def _ssd(xh, a, B_, C_, chunk):
        S2 = Shard(2)
        return [([S0], [S0, S0, S0, S0, None]),
                ([S2], [S2, S2, R, R, None]),
                ([R], [R, R, R, R, None])]

    # ``aten.flip`` (the backward of a cumsum, the SSD's decay sums) has
    # no rule in older torch: shard any dim it does not flip
    @register_sharding(torch.ops.aten.flip.default)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
                if d not in flipped] + [([R], [R, None])]

    _DONE = True
