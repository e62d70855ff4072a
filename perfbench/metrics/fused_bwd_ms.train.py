"""``fused_bwd_ms.train``: milliseconds of device work (kernels, copies and
memsets) launched inside the program's spans of the four fused ops'
backwards, summed over their calls in the traced run (one iteration of
the phases: every backward of the step once).

The spans wrap the registered backwards of ``kernels/fused/ops.py``
(``_rmsnorm_bwd``, ``_rmsnorm_residual_bwd``, ``_layernorm_bwd``,
``_swiglu_bwd``): today each recomputes the plain math and
differentiates it."""

SPANS = ("repro_torch::rmsnorm.bwd", "repro_torch::rmsnorm_residual.bwd",
         "repro_torch::layernorm.bwd", "repro_torch::swiglu.bwd")


def read(ctx):
    calls = [evs for name in SPANS for _, evs in ctx.trace.calls(name)]
    if not calls:
        return None
    return sum(e.end - e.start for evs in calls for e in evs) * 1e-6
