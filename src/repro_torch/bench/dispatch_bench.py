"""Dispatch routing gates: measured-best must not lose to static fusion
(port of ``benchmarks/dispatch_bench.py``).

The acceptance contract of the measured dispatch
(``repro_torch.tune.dispatch``), as two gates that each *raise* on a
violation (so the suite errs and ``python -m repro_torch.bench`` exits 1):

* **step gate** — the measured-dispatch train step (``fusion="auto"``
  routed by a filled, frozen dispatch table) must be ≤ the static fused
  step (``fusion="static"``) within :data:`STEP_TOLERANCE`.  Each site
  routes to the measured min of {fused, reference}, so the whole step can
  only lose to static through timing noise, which the tolerance (10%)
  covers and nothing more;
* **table gate** — no stored winner may be slower than the loser it
  replaced: every :class:`~repro_torch.tune.dispatch.DispatchRecord`
  holds ``wall(impl) <= wall(other)``, true by ``measure_site``'s
  construction, which the gate guards.

The ``off`` step is timed too, for the headline before/after.  The walls
are CUDA events on the card, the host clock on the host; the bounds are
against the device's datasheet.  ``bench_rows`` takes the depth and
width as keywords whose defaults are the reference's sizes (the smoke
config at the census shape).

Run: ``python -m repro_torch.bench --only dispatch_bench [--device cpu]``.
"""

from __future__ import annotations

import tempfile

import torch

from repro_torch.bench.common import Row, datasheet
from repro_torch.bench.zero_ai_census import LM_BATCH, LM_CONFIG, LM_SEQ

# measured step must satisfy wall_auto <= wall_static * STEP_TOLERANCE:
# per-site routing picks the measured min, so only timing noise can push
# the routed step above static — 10% bounds that noise
STEP_TOLERANCE = 1.10


def step_gate(walls: dict[str, float]) -> None:
    """Raise unless the measured-dispatch step (``walls["auto"]``) stays
    within :data:`STEP_TOLERANCE` of the static one."""
    if walls["auto"] > walls["static"] * STEP_TOLERANCE:
        raise AssertionError(
            f"measured-dispatch step {walls['auto']*1e6:.1f}us exceeds "
            f"static fused step {walls['static']*1e6:.1f}us by more than "
            f"the {STEP_TOLERANCE}x noise tolerance — routing is picking "
            "losers")


def table_violations(table) -> list[str]:
    """The stored winners slower than the impl they replaced."""
    bad = []
    for rec in table:
        win = rec.fused_wall_s if rec.impl == "fused" else rec.ref_wall_s
        lose = rec.ref_wall_s if rec.impl == "fused" else rec.fused_wall_s
        if win > lose:
            bad.append(f"{rec.op}[{rec.key}]: {rec.impl} "
                       f"{win*1e6:.1f}us > {lose*1e6:.1f}us")
    return bad


def bench_rows(config: str = LM_CONFIG, seq: int = LM_SEQ,
               batch: int = LM_BATCH, iters: int = 3, warmup: int = 1, *,
               device: str | torch.device = "cuda", smoke: bool = True,
               n_layers: int | None = None) -> list[Row]:
    from repro_torch.configs.base import RunConfig
    from repro_torch.device import resolve_device
    from repro_torch.trace.cli import build_phase_args
    from repro_torch.trace.collector import collect_phases
    from repro_torch.tune import dispatch as dsp
    from repro_torch.tune.store import TuneStore, machine_for

    dev = resolve_device(device)
    machine = datasheet(dev)
    out: list[Row] = []
    walls: dict[str, float] = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = TuneStore(f"{tmp}/tune.json")
        # fill the table at the bench shape, then freeze: the timed steps
        # below never pay (or hide) measurement cost
        search = dsp.search_sites(config, seq=seq, batch=batch, store=store,
                                  smoke=smoke, n_layers=n_layers,
                                  device=dev)
        for fusion in ("off", "static", "auto"):
            run = RunConfig(amp="O1", fusion=fusion)
            phases = build_phase_args(config, run, seq=seq, batch=batch,
                                      smoke=smoke, n_layers=n_layers,
                                      device=dev)
            with dsp.dispatch_scope(store=store, mode="frozen",
                                    machine=machine_for(dev), device=dev):
                ms = collect_phases(phases, machine=machine, iters=iters,
                                    warmup=warmup, matmul_class="bf16")
            del phases
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            walls[fusion] = sum(m.wall_s for m in ms.values())
        table = dsp.dispatch_table(store)

    out.append(("dispatch_bench/step_off", walls["off"] * 1e6, ""))
    out.append(("dispatch_bench/step_static", walls["static"] * 1e6,
                f"vs_off={walls['off']/walls['static']:.2f}x"))
    out.append(("dispatch_bench/step_measured", walls["auto"] * 1e6,
                f"vs_off={walls['off']/walls['auto']:.2f}x;"
                f"vs_static={walls['static']/walls['auto']:.2f}x;"
                f"sites={search.n_sites};tolerance={STEP_TOLERANCE}"))
    step_gate(walls)

    bad = table_violations(table)
    n_fused = sum(1 for r in table if r.impl == "fused")
    out.append(("dispatch_bench/table_gate", 0.0,
                f"winners={len(table)};fused={n_fused};"
                f"reference={len(table) - n_fused};violations={len(bad)}"))
    if bad:
        raise AssertionError(
            "stored dispatch winner(s) slower than the impl they "
            "replaced: " + "; ".join(bad))
    return out


def main(device: str | torch.device = "cuda") -> list[Row]:
    return bench_rows(device=device)
