"""Observability over the workspace stores (port of ``repro.obs``).

Three capabilities, all store-only (nothing is walked or timed again):

* :func:`merge_workspace` — the union of another workspace's trace,
  sweep and tune stores (and bench harvests) into this one, conflicts
  skipped and reported, the provenance in ``workspace.json``;
* :func:`collect_series` / :func:`gate_series` — perf-trend series over
  stored records and ``BENCH_*.json`` harvests, an ASCII sparkline report
  and a CI regression gate;
* :func:`advise` — a rule engine that mines the stored payloads for known
  bottleneck patterns and ranks evidence-cited remediations.

``python -m repro_torch {merge,trend,advise}`` and
``Session.merge/trend/advise`` are this package as a CLI and an API.
The names load lazily (PEP 562).
"""

from typing import Any

_LAZY = {
    "Finding": "repro_torch.obs.advisor",
    "RULES": "repro_torch.obs.advisor",
    "advise": "repro_torch.obs.advisor",
    "render_findings": "repro_torch.obs.advisor",
    "MergeReport": "repro_torch.obs.merge",
    "merge_workspace": "repro_torch.obs.merge",
    "render_merge": "repro_torch.obs.merge",
    "Regression": "repro_torch.obs.trend",
    "TrendSeries": "repro_torch.obs.trend",
    "collect_series": "repro_torch.obs.trend",
    "gate_series": "repro_torch.obs.trend",
    "render_trend": "repro_torch.obs.trend",
    "sparkline": "repro_torch.obs.trend",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str) -> Any:
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
