"""Synthetic many-user arrival traces for the serving engine (port of
``repro.serve.workload``).

A *trace* is a list of :class:`~repro_torch.serve.engine.Request` objects with
``arrival`` set in engine ticks — the deterministic virtual clock the
scheduler tests drive tick-by-tick.  Two seeded generators:

* ``poisson_trace``: i.i.d. exponential inter-arrival gaps at ``rate``
  requests per tick — the classic open-loop many-user model;
* ``bursty_trace``: groups of ``burst`` simultaneous arrivals separated
  by exponential gaps — the thundering-herd shape that exercises queue
  depth and admission fairness.

Prompt tokens and lengths come from the same ``numpy`` generator, so one
seed pins the whole workload (arrivals, prompts, decode budgets), request
for request the same trace as the reference's for the same seed.
"""

from __future__ import annotations

import numpy as np


def _requests(rng: np.random.Generator, arrivals: np.ndarray, vocab: int,
              prompt_len: tuple[int, int], max_new: tuple[int, int]) -> list:
    from repro_torch.serve.engine import Request
    out = []
    for i, at in enumerate(arrivals):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = rng.integers(0, vocab, size=max(plen, 0)).astype(np.int32)
        out.append(Request(
            uid=i, prompt=prompt,
            max_new=int(rng.integers(max_new[0], max_new[1] + 1)),
            arrival=int(at)))
    return out


def poisson_trace(n_requests: int, *, rate: float = 1.0, seed: int = 0,
                  vocab: int = 256, prompt_len: tuple[int, int] = (4, 16),
                  max_new: tuple[int, int] = (4, 16)) -> list:
    """``n_requests`` with Exp(1/rate) inter-arrival gaps (ticks)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    return _requests(rng, arrivals, vocab, prompt_len, max_new)


def bursty_trace(n_requests: int, *, burst: int = 4, rate: float = 0.25,
                 seed: int = 0, vocab: int = 256,
                 prompt_len: tuple[int, int] = (4, 16),
                 max_new: tuple[int, int] = (4, 16)) -> list:
    """Bursts of ``burst`` simultaneous arrivals, Exp-gapped at ``rate``
    bursts per tick."""
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    rng = np.random.default_rng(seed)
    n_bursts = -(-n_requests // burst)
    gaps = rng.exponential(1.0 / rate, size=n_bursts)
    burst_at = np.floor(np.cumsum(gaps)).astype(np.int64)
    arrivals = np.repeat(burst_at, burst)[:n_requests]
    return _requests(rng, arrivals, vocab, prompt_len, max_new)


TRACES = {"poisson": poisson_trace, "bursty": bursty_trace}


def make_trace(kind: str, n_requests: int, **kw) -> list:
    if kind not in TRACES:
        raise KeyError(f"unknown arrival trace {kind!r}; "
                       f"valid: {sorted(TRACES)}")
    return TRACES[kind](n_requests, **kw)
