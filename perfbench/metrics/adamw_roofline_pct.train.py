"""``adamw_roofline_pct.train``: the multi-tensor AdamW kernel's share of
its bound, Σ bound / Σ device time over every call of the op
``repro_torch::adamw_multi_`` in the traced run (the opt phase's).

A call updates every leaf of the model (each is float32 and eligible),
so it is bound by the bytes of the whole parameter count: g, m, v and p
read, p, m and v written."""

from perfbench import yardstick

OP = "repro_torch::adamw_multi_"


def read(ctx):
    if ctx.peaks is None:
        return None
    bound = busy = 0.0
    for _, events in ctx.trace.calls(OP):
        bound += yardstick.adamw_bytes(ctx.params) / ctx.peaks["hbm"]
        busy += sum(e.end - e.start for e in events) * 1e-9
    return 100.0 * bound / busy if busy else None
