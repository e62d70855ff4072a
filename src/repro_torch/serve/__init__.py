"""Continuous-batching serving (port of ``repro.serve``): paged KV-cache,
arrival traces, metrics, and per-phase (prefill/decode) roofline
attribution."""

from repro_torch.serve.engine import SERVABLE_FAMILIES, Engine, Request
from repro_torch.serve.metrics import (ServeStats, percentile,
                                       stats_from_requests)
from repro_torch.serve.paged_kv import DEFAULT_PAGE_SIZE, PagedKVCache
from repro_torch.serve.workload import (TRACES, bursty_trace, make_trace,
                                        poisson_trace)

__all__ = [
    "Engine", "Request", "SERVABLE_FAMILIES",
    "ServeStats", "percentile", "stats_from_requests",
    "DEFAULT_PAGE_SIZE", "PagedKVCache",
    "TRACES", "bursty_trace", "make_trace", "poisson_trace",
]
