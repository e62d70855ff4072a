"""``bwd_launches.train``: the device events (kernels, copies and memsets)
launched inside any of the program's six backward spans
(``repro_torch::<op>.bwd``) in the traced run (one iteration of the
phases: every backward of the step once), each counted once.

A count of what the host launches for the hand-written backwards: their
plain recomputes launch many small kernels, and the host's pace at that
is behind the device's idle share where the step is host-paced."""

SPANS = ("repro_torch::flash_attention.bwd", "repro_torch::ssd_scan.bwd",
         "repro_torch::rmsnorm.bwd", "repro_torch::rmsnorm_residual.bwd",
         "repro_torch::layernorm.bwd", "repro_torch::swiglu.bwd")


def read(ctx):
    events = {id(e): e for name in SPANS
              for _, evs in ctx.trace.calls(name) for e in evs}
    return len(events) or None
