"""``attn_bwd_ms.train``: milliseconds of device work (kernels, copies and
memsets) launched inside the program's span
``repro_torch::flash_attention.bwd``, summed over its calls in the traced
run (one iteration of the phases: every backward of the step once).

The span wraps the flash op's whole registered backward
(``kernels/flash_attention/ops.py::_flash_bwd``): today the plain
attention recompute and its gradient, later a backward kernel."""

SPANS = ("repro_torch::flash_attention.bwd",)


def read(ctx):
    calls = [evs for name in SPANS for _, evs in ctx.trace.calls(name)]
    if not calls:
        return None
    return sum(e.end - e.start for evs in calls for e in evs) * 1e-6
