"""``rmsnorm_roofline_pct.train``: the two fused RMSNorm kernels' share of
their bound, Σ bound / Σ device time over every call of the ops
``repro_torch::rmsnorm`` and ``repro_torch::rmsnorm_residual`` in the
traced run (forward calls; their backwards recompute plain math).

A call is bound by its bytes: x (and the residual h) read and y (and
the sum r) written in the activation dtype, the scale read once."""

from perfbench import yardstick

OPS = {"repro_torch::rmsnorm": False, "repro_torch::rmsnorm_residual": True}
ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}


def read(ctx):
    if ctx.peaks is None:
        return None
    bound = busy = 0.0
    for name, residual in OPS.items():
        for op, events in ctx.trace.calls(name):
            rows, d = op.shapes[0]
            nbytes = yardstick.rmsnorm_bytes(
                rows, d, ITEMSIZE[op.dtypes[0]], residual,
                ITEMSIZE[op.dtypes[2 if residual else 1]])
            bound += nbytes / ctx.peaks["hbm"]
            busy += sum(e.end - e.start for e in events) * 1e-9
    return 100.0 * bound / busy if busy else None
