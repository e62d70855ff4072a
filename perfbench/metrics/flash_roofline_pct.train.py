"""``flash_roofline_pct.train``: the flash-attention forward kernel's share
of its roofline bound, Σ bound / Σ device time over every call of the op
``repro_torch::flash_attention`` in the traced run (the fwd phase's and
the forward inside the bwd phase; the backward recomputes plain
attention, which is not this op).

A call's bound is ``yardstick.bound_s`` of the causal 2·B·H·S²·hd FLOPs
at the bf16 peak (fp32 operands: the fp32 peak) and Q, K, V read once at
their own head counts and O written once."""

from perfbench import yardstick

OP = "repro_torch::flash_attention"
ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}


def read(ctx):
    if ctx.peaks is None:
        return None
    bound = busy = 0.0
    for op, events in ctx.trace.calls(OP):
        b, s, kv, g, hd = op.shapes[0]          # q (B, S, KV, G, hd)
        size = ITEMSIZE[op.dtypes[0]]
        rate = ctx.peaks["bf16"] if size == 2 else ctx.peaks["fp32"]
        bound += yardstick.bound_s(
            yardstick.flash_flops(b, kv * g, s, hd),
            yardstick.flash_bytes(b, s, kv * g, kv, hd, size), rate,
            ctx.peaks["hbm"])
        busy += sum(e.end - e.start for e in events) * 1e-9
    return 100.0 * bound / busy if busy else None
