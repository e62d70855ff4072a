"""``fwd_bwd_ms.train``: milliseconds of the bwd phase (``make_phases``
``bwd``: the forward and then the backward, to every gradient), the mean
over the traced run's calls, each timed by CUDA events around it."""


def read(ctx):
    ms = ctx.phase_ms.get("bwd") or []
    return sum(ms) / len(ms) if ms else None
