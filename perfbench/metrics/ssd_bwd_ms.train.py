"""``ssd_bwd_ms.train``: milliseconds of device work (kernels, copies and
memsets) launched inside the program's span ``repro_torch::ssd_scan.bwd``,
summed over its calls in the traced run (one iteration of the phases:
every backward of the step once).

The span wraps the SSD op's whole registered backward
(``kernels/ssd_scan/ops.py::_ssd_bwd``): today the plain chunked scan
recomputed and differentiated, later a backward kernel."""

SPANS = ("repro_torch::ssd_scan.bwd",)


def read(ctx):
    calls = [evs for name in SPANS for _, evs in ctx.trace.calls(name)]
    if not calls:
        return None
    return sum(e.end - e.start for evs in calls for e in evs) * 1e-6
