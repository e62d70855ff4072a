"""``idle_pct.train``: the share of the traced window in which the device
ran no kernel, copy or memset (``torch.profiler``, CUDA activity)."""


def read(ctx):
    if ctx.traced_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s)
