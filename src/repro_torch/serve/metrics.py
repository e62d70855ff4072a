"""Serving latency/throughput metrics: TTFT, per-token latency, tokens/s
(port of ``repro.serve.metrics``).

Two clocks, deliberately separate:

* the **tick clock** (integer engine ticks) — deterministic, what the
  scheduler-invariant tests assert on (queue wait bounds, FIFO order);
* the **wall clock** (``time.perf_counter`` stamps the engine records at
  each request's arrival/first-token/completion; on a CUDA device
  after the card has finished) — what the latency percentiles report.

``percentile`` is a tiny nearest-rank implementation so the report never
depends on interpolation-mode defaults shifting across numpy versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    vs = sorted(values)
    if not vs:
        return 0.0
    rank = max(1, math.ceil(q / 100.0 * len(vs)))
    return vs[min(rank, len(vs)) - 1]


@dataclasses.dataclass
class ServeStats:
    """One serve run's aggregate numbers (built from finished requests)."""

    n_requests: int
    n_completed: int
    n_rejected: int
    n_cancelled: int
    total_new_tokens: int
    wall_s: float                     # whole-run wall
    ticks: int
    ttft_s: list[float]               # per completed request
    tpot_s: list[float]               # per-output-token latency, per request
    queue_wait_ticks: list[int]       # admit_tick - arrival_tick
    prefill_wall_s: float = 0.0       # summed compiled prefill-call wall
    decode_wall_s: float = 0.0        # summed compiled decode-call wall

    @property
    def tokens_per_s(self) -> float:
        return self.total_new_tokens / self.wall_s if self.wall_s else 0.0

    def gate(self, *, max_ttft_p99_s: float = 60.0,
             max_tpot_p99_s: float = 60.0) -> list[str]:
        """Latency-gate violations (empty = pass).  The absolute bounds
        are generous on purpose: the CI gate catches a wedged engine or a
        pathological scheduler, not host noise."""
        problems = []
        if self.n_completed < self.n_requests - self.n_rejected \
                - self.n_cancelled:
            problems.append(
                f"{self.n_requests - self.n_rejected - self.n_cancelled - self.n_completed} "
                "admitted request(s) never completed")
        if self.n_completed and not self.total_new_tokens:
            problems.append("completed requests produced no tokens")
        p99_ttft = percentile(self.ttft_s, 99)
        if p99_ttft > max_ttft_p99_s:
            problems.append(f"p99 TTFT {p99_ttft:.3f}s > {max_ttft_p99_s}s")
        p99_tpot = percentile(self.tpot_s, 99)
        if p99_tpot > max_tpot_p99_s:
            problems.append(
                f"p99 per-token {p99_tpot:.3f}s > {max_tpot_p99_s}s")
        return problems

    def summary(self) -> dict[str, Any]:
        return {
            "requests": self.n_requests,
            "completed": self.n_completed,
            "rejected": self.n_rejected,
            "cancelled": self.n_cancelled,
            "new_tokens": self.total_new_tokens,
            "ticks": self.ticks,
            "wall_s": self.wall_s,
            "tokens_per_s": self.tokens_per_s,
            "ttft_p50_s": percentile(self.ttft_s, 50),
            "ttft_p99_s": percentile(self.ttft_s, 99),
            "tpot_p50_s": percentile(self.tpot_s, 50),
            "tpot_p99_s": percentile(self.tpot_s, 99),
            "queue_wait_max_ticks": max(self.queue_wait_ticks, default=0),
            "prefill_wall_s": self.prefill_wall_s,
            "decode_wall_s": self.decode_wall_s,
        }

    def render(self) -> str:
        s = self.summary()
        return "\n".join([
            f"requests   {s['completed']}/{s['requests']} completed "
            f"({s['rejected']} rejected, {s['cancelled']} cancelled) "
            f"in {s['ticks']} ticks / {s['wall_s']:.3f}s",
            f"throughput {s['new_tokens']} new tokens, "
            f"{s['tokens_per_s']:.1f} tok/s",
            f"TTFT       p50 {s['ttft_p50_s'] * 1e3:.1f} ms | "
            f"p99 {s['ttft_p99_s'] * 1e3:.1f} ms",
            f"per-token  p50 {s['tpot_p50_s'] * 1e3:.1f} ms | "
            f"p99 {s['tpot_p99_s'] * 1e3:.1f} ms",
            f"queue      max wait {s['queue_wait_max_ticks']} tick(s)",
            f"phase wall prefill {s['prefill_wall_s']:.3f}s | "
            f"decode {s['decode_wall_s']:.3f}s",
        ])


def stats_from_requests(requests: list, *, wall_s: float, ticks: int,
                        prefill_wall_s: float = 0.0,
                        decode_wall_s: float = 0.0) -> ServeStats:
    """Fold finished :class:`~repro_torch.serve.engine.Request`s into stats."""
    completed = [r for r in requests if r.status == "done"]
    rejected = [r for r in requests if r.status == "rejected"]
    cancelled = [r for r in requests if r.status == "cancelled"]
    ttft = [r.t_first - r.t_arrival for r in completed
            if r.t_first is not None and r.t_arrival is not None]
    tpot = []
    for r in completed:
        if r.t_done is not None and r.t_first is not None and len(r.out) > 1:
            tpot.append((r.t_done - r.t_first) / (len(r.out) - 1))
    waits = [r.admit_tick - r.arrival for r in requests
             if r.admit_tick is not None]
    return ServeStats(
        n_requests=len(requests),
        n_completed=len(completed),
        n_rejected=len(rejected),
        n_cancelled=len(cancelled),
        total_new_tokens=sum(len(r.out) for r in requests),
        wall_s=wall_s, ticks=ticks,
        ttft_s=ttft, tpot_s=tpot, queue_wait_ticks=waits,
        prefill_wall_s=prefill_wall_s, decode_wall_s=decode_wall_s)
