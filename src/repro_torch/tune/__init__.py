"""Kernel autotuning with a persistent best-config store, and the
measured fused-vs-reference dispatch table (port of ``repro.tune``; the
paper's §II-A discipline: ceilings and kernel timings come from tuned
configurations, not from whatever the default launch happens to give).

* :mod:`~repro_torch.tune.store` — the JSON store (the reference's
  schema), :func:`best_config` / :func:`config_source`;
* :mod:`~repro_torch.tune.space` — the Hopper candidate spaces;
* :mod:`~repro_torch.tune.search` — :func:`search` / :func:`search_all` /
  :func:`tune_ceilings`, and :func:`tune_workload`, which searches the
  points whose winners something reads (a store hit times nothing);
* :mod:`~repro_torch.tune.dispatch` — the site-keyed table that
  ``fusion="auto"`` routes through;
* ``python -m repro_torch tune`` — search / show / apply and
  ``dispatch {search,show,apply}``.
"""

from repro_torch.tune.dispatch import (DispatchKey, DispatchMiss,
                                       DispatchRecord, active_dispatch_table,
                                       best_impl, dispatch_scope)
from repro_torch.tune.search import (TuneOutcome, ceiling_shapes, search,
                                     search_all, search_step, tune_ceilings,
                                     tune_workload)
from repro_torch.tune.store import (TuneRecord, TuneStore,
                                    active_kernel_configs, best_config,
                                    config_source, default_store_path,
                                    tune_key, tuned_kernels)

__all__ = [
    "DispatchKey", "DispatchMiss", "DispatchRecord", "TuneOutcome",
    "TuneRecord", "TuneStore", "active_dispatch_table",
    "active_kernel_configs", "best_config", "best_impl", "ceiling_shapes",
    "config_source", "default_store_path", "dispatch_scope", "search",
    "search_all", "search_step", "tune_ceilings", "tune_key",
    "tune_workload", "tuned_kernels",
]
