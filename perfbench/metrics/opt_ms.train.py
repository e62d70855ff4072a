"""``opt_ms.train``: milliseconds of the opt phase (``make_phases``
``opt``: the AdamW update of every leaf, its host-side leaf table
included), the mean over the traced run's calls, each timed by CUDA
events around it."""


def read(ctx):
    ms = ctx.phase_ms.get("opt") or []
    return sum(ms) / len(ms) if ms else None
