"""``fwd_ms.train``: milliseconds of the fwd phase (``make_phases``
``fwd``: the loss forward, no gradient), the mean over the traced run's
calls, each timed by CUDA events around it."""


def read(ctx):
    ms = ctx.phase_ms.get("fwd") or []
    return sum(ms) / len(ms) if ms else None
