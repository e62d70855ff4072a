"""``ssd_roofline_pct.train``: the SSD scan kernels' share of their roofline
bound, Σ bound / Σ device time over every call of the op
``repro_torch::ssd_scan`` in the traced run (its three launches a call;
the backward recomputes the plain scan, which is not this op).

A call's bound is ``yardstick.bound_s`` of the scan's needed FLOPs at
the TF32 tensor-core peak (the scan is an fp32 op, and no
implementation that holds fp32 accuracy runs faster than that peak) and
x, the log-decay, B and C read once and y written once."""

from perfbench import yardstick

OP = "repro_torch::ssd_scan"


def read(ctx):
    if ctx.peaks is None:
        return None
    bound = busy = 0.0
    for op, events in ctx.trace.calls(OP):
        b, s, h, p = op.shapes[0]               # xh (B, S, H, P)
        n = op.shapes[2][-1]                    # B (B, S, N)
        chunk = min(int(ctx.model["ssm_chunk"]), s)
        bound += yardstick.bound_s(
            yardstick.ssd_needed_flops(b, h, s, p, n, chunk),
            yardstick.ssd_bytes(b, h, s, p, n), ctx.peaks["tf32"],
            ctx.peaks["hbm"])
        busy += sum(e.end - e.start for e in events) * 1e-9
    return 100.0 * bound / busy if busy else None
