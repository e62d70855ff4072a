"""The program's own spans: a named profiler range around each
hand-written backward.

Every backward that the port registers by hand (``register_autograd`` on
a ``repro_torch::`` op) runs inside ``record_function("<op>.bwd")`` while
a profiler runs (``torch.profiler.profile``, ``emit_nvtx``, ``emit_itt``),
so its device work is found by the span's name: each kernel, copy and
memset links to the op that launched it, and that op sits inside the
span on the profiler's own clock.  The span wraps the whole registered
backward, not its recompute, so a backward kernel that replaces the
recompute stays under the same name.

With no profiler running the wrapper reads one flag and calls the
backward; it builds no ``RecordFunction``.

:data:`SPANS` is every span name the program emits; the benchmark's
readers of backward time name their spans from it.
"""

from __future__ import annotations

import functools
from typing import Callable

from torch.autograd import profiler as _profiler

#: every span the program emits, one per hand-written backward
SPANS = tuple(f"repro_torch::{op}.bwd" for op in (
    "flash_attention", "ssd_scan", "rmsnorm", "rmsnorm_residual",
    "layernorm", "swiglu"))


def backward_span(op_name: str) -> Callable[[Callable], Callable]:
    """Decorator for the registered backward of the op ``op_name``: the
    backward runs inside the span ``f"{op_name}.bwd"`` while a profiler
    runs, and is called directly otherwise."""
    span = f"{op_name}.bwd"
    if span not in SPANS:
        raise ValueError(f"{span!r} is not one of the program's spans "
                         f"{SPANS}")

    def wrap(bwd: Callable) -> Callable:
        @functools.wraps(bwd)
        def run(ctx, *grads):
            # read through the module: torch sets the flag on every
            # profiler's start and stop
            if not _profiler._is_profiler_enabled:
                return bwd(ctx, *grads)
            with _profiler.record_function(span):
                return bwd(ctx, *grads)
        return run
    return wrap
