"""The fusion loop's verify half: census gate and measured before/after
(port of ``benchmarks/fused_bench.py``).

Three sections, all on the LM config the zero-AI census diagnoses:

* **micro** — each hand-written fused kernel timed against the plain
  chain it replaces (norm + residual, the SwiGLU epilogue, the AdamW
  leaf update) at the reference's mid-size shapes, fp32 (2048, 512) and
  a 1,048,576-element AdamW leaf: the per-kernel before/after pair;
* **census gate** — the LM train-step launch census
  (``zero_ai_census``) under ``fusion="off"`` against ``"static"``;
  *raises* (so the suite errs and ``python -m repro_torch.bench``
  exits 1) unless the fused step launches strictly fewer kernels and
  cuts zero-AI launches by at least :data:`ZERO_AI_GATE`;
* **trace** — a measured trace of the same config in the three routing
  modes (``off`` / ``static`` / measured-dispatch ``auto``, row tags
  ``reference`` / ``fused`` / ``measured``, so ``python -m repro_torch
  trend`` follows the routing win per host): the wall per phase and the
  achieved fraction of each memory level's bandwidth (HBM and the
  on-chip ``l2``, the reference's ``vmem``).  The ``auto`` trace routes
  by a dispatch table that a ``search_sites`` pass fills at the trace
  shape first and that is then frozen: no measurement leaks into the
  timed step.

``main`` runs them in that order, so while the census gate fails the
suite carries no rows (as the reference's).  ``trace_rows`` takes the
depth and width as keywords whose defaults are the reference's sizes.

Run: ``python -m repro_torch.bench --only fused_bench [--device cpu]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.bench.common import Row, datasheet, timed
from repro_torch.bench.zero_ai_census import LM_BATCH, LM_CONFIG, LM_SEQ

# CI gate: fused zero-AI launches must drop by at least this fraction
ZERO_AI_GATE = 0.30
# the measured-trace shape (the reference's: its fused one-hot embedding
# backward only clears host noise at longer sequences); the census gate
# stays at the zero_ai_census shape
TRACE_SEQ = 256


# --------------------------------------------------------------------------
# Micro: fused kernel against the plain chain it replaces
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MicroCase:
    """One micro row's kernel and plain chain on the same operands, with
    the bytes the kernel must move and its operations (its roofline
    bound's two terms)."""

    name: str
    fused: Callable
    plain: Callable
    args: tuple
    nbytes: float
    nflops: float


def micro_cases(device: str | torch.device = "cuda", rows_n: int = 2048,
                d: int = 512) -> list[MicroCase]:
    """The reference's three micro rows, fp32: residual RMSNorm and the
    SwiGLU epilogue at (rows_n, d), one AdamW leaf of rows_n·d elements
    (bias corrections 0.1, the reference's hyperparameters)."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.fused import adamw, norm, swiglu

    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    f32 = dict(device=dev, dtype=torch.float32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, **f32)

    x, h, s = randn(rows_n, d), randn(rows_n, d), torch.ones(d, **f32)

    def norm_ref(x_, h_, s_):
        r = x_ + h_
        var = torch.mean(r * r, dim=-1, keepdim=True)
        return r, r * torch.rsqrt(var + 1e-5) * s_

    g, u = randn(rows_n, d), randn(rows_n, d)
    n = rows_n * d
    gr, p = randn(n), randn(n)
    m, v = torch.zeros(n, **f32), torch.zeros(n, **f32)
    bc = torch.full((2,), 0.1, **f32)

    def adamw_ref(g_, m_, v_, p_, b_):
        m2 = 0.9 * m_ + 0.1 * g_
        v2 = 0.95 * v_ + 0.05 * g_ * g_
        step = (m2 / b_[0]) / (torch.sqrt(v2 / b_[1]) + 1e-8)
        return p_ - 3e-4 * (step + 0.1 * p_), m2, v2

    return [
        MicroCase("norm_residual", norm.fused_rmsnorm_residual, norm_ref,
                  (x, h, s), norm.hbm_bytes(rows_n, d, 4, residual=True),
                  norm.flops(rows_n, d, residual=True)),
        MicroCase("swiglu", swiglu.fused_swiglu,
                  lambda a, b: torch.nn.functional.silu(a) * b, (g, u),
                  swiglu.hbm_bytes(rows_n, d, 4), swiglu.flops(rows_n, d)),
        MicroCase("adamw", adamw.fused_adamw, adamw_ref, (gr, m, v, p, bc),
                  adamw.hbm_bytes(n), adamw.flops(n)),
    ]


def micro_rows(device: str | torch.device = "cuda") -> list[Row]:
    """Per-kernel before/after at a mid shape (CUDA events on the card,
    the host clock on the host, where the "kernel" is its plain
    version)."""
    out: list[Row] = []
    for c in micro_cases(device):
        dev = c.args[0].device
        t_ref = timed(c.plain, *c.args, device=dev)
        t_fused = timed(c.fused, *c.args, device=dev)
        out.append((f"fused_bench/{c.name}", t_fused,
                    f"ref={t_ref:.1f}us;speedup={t_ref/t_fused:.2f}x"))
    return out


# --------------------------------------------------------------------------
# Census gate
# --------------------------------------------------------------------------

def census_gate_rows(config: str = LM_CONFIG,
                     device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.bench.zero_ai_census import (lm_phase_census,
                                                  lm_step_summary)
    s = lm_step_summary(lm_phase_census(config, LM_SEQ, LM_BATCH, device))
    n_ref, n_fus = s["launches_ref"], s["launches_fused"]
    red = s["zero_reduction"]
    row: Row = ("fused_bench/census_gate", 0.0,
                f"launches={n_ref}vs{n_fus};"
                f"zero={s['zero_ref']}vs{s['zero_fused']};"
                f"zero_reduction={red:.2f}")
    if n_fus >= n_ref:
        raise AssertionError(
            f"fused LM train step launches {n_fus} kernels, reference "
            f"{n_ref} — fusion must be strictly lower ({row[2]})")
    if red < ZERO_AI_GATE:
        raise AssertionError(
            f"fused zero-AI reduction {red:.2f} below the {ZERO_AI_GATE} "
            f"gate ({row[2]})")
    return [row]


# --------------------------------------------------------------------------
# Measured trace: reference against fused, same config, same machine model
# --------------------------------------------------------------------------

def _level_fractions(m, machine) -> str:
    """Achieved fraction of each memory level's bandwidth for one phase."""
    hbm = (m.hbm_bytes / m.wall_s) / machine.hbm.bytes_per_s
    onchip = (m.vmem_bytes / m.wall_s) / machine.vmem.bytes_per_s
    return (f"hbm_frac={hbm:.3f};{machine.vmem.name}_frac={onchip:.3f};"
            f"roof={m.pct_of_roofline:.3f}")


_TRACE_TAGS = {"off": "reference", "static": "fused", "auto": "measured"}


def trace_rows(config: str = LM_CONFIG, iters: int = 3, warmup: int = 1,
               *, device: str | torch.device = "cuda",
               smoke: bool = True, n_layers: int | None = None,
               seq: int = TRACE_SEQ, batch: int = LM_BATCH) -> list[Row]:
    """off / static / measured-dispatch walls of the same train step.

    Row names: ``trace_{phase}_{reference|fused|measured}``, then
    ``trace_step`` (the static wall) and ``trace_step_measured`` (the
    dispatch-routed wall with its speedup over both).  The dispatch table
    lives in a throwaway tune store.  ``smoke``, ``n_layers``, ``seq`` and ``batch`` size the step (the
    defaults are the reference's: the smoke config at :data:`TRACE_SEQ`).
    The bounds are against the device's datasheet."""
    import tempfile

    from repro_torch.configs.base import RunConfig
    from repro_torch.device import resolve_device
    from repro_torch.trace.cli import build_phase_args
    from repro_torch.trace.collector import collect_phases
    from repro_torch.tune import dispatch as dsp
    from repro_torch.tune.store import machine_for

    dev = resolve_device(device)
    machine = datasheet(dev)
    out: list[Row] = []
    walls: dict[str, float] = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = f"{tmp}/tune.json"
        # fill the dispatch table at the trace shape first, so the timed
        # auto trace routes by table hits only (frozen raises on a miss)
        dsp.search_sites(config, seq=seq, batch=batch, store=store,
                         smoke=smoke, n_layers=n_layers, device=dev)
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
            tag = _TRACE_TAGS[fusion]
            for phase, m in ms.items():
                out.append((f"fused_bench/trace_{phase}_{tag}",
                            m.wall_s * 1e6, _level_fractions(m, machine)))
            walls[fusion] = sum(m.wall_s for m in ms.values())
    out.append(("fused_bench/trace_step", walls["static"] * 1e6,
                f"ref={walls['off']*1e6:.1f}us;"
                f"speedup={walls['off']/walls['static']:.2f}x"))
    out.append(("fused_bench/trace_step_measured", walls["auto"] * 1e6,
                f"ref={walls['off']*1e6:.1f}us;"
                f"static={walls['static']*1e6:.1f}us;"
                f"speedup_vs_ref={walls['off']/walls['auto']:.2f}x;"
                f"speedup_vs_static={walls['static']/walls['auto']:.2f}x"))
    return out


def main(device: str | torch.device = "cuda") -> list[Row]:
    rows = micro_rows(device)
    rows += census_gate_rows(device=device)
    rows += trace_rows(device=device)
    return rows
