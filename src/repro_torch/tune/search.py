"""The empirical search loop: build every candidate, time it, keep the
winner (port of ``repro.tune.search``).

Timing is the ERT driver's (``kernels/ert/ops.py::time_launches``: CUDA
events around back-to-back calls on the card, at least 10 ms of them, the
host clock on the host); a candidate's wall is the *minimum* over
``iters`` such samples after ``warmup`` calls (noise only ever adds
time).  A candidate that carries its own timer is timed with it: the GEMM
ceiling's, so that the tuned ceiling is timed as the untuned one
(``ops.time_gemm``).  The stored record keeps the default config's numbers beside the
winner's, so every consumer can report before / after.

A point already in the :class:`~repro_torch.tune.store.TuneStore` returns
the stored winner without timing anything (``cached=True``) unless
``force=True`` or the winner was measured with another build of its
kernel's library (``store.current``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.tune import space as sp
from repro_torch.tune.store import (TuneRecord, TuneStore, _as_store,
                                    current, make_record, shape_key,
                                    tune_key)


@dataclasses.dataclass
class CandidateResult:
    params: dict[str, Any]
    wall_s: float
    metric: float
    is_default: bool


@dataclasses.dataclass
class TuneOutcome:
    record: TuneRecord
    candidates: list[CandidateResult]     # [] on a store hit
    cached: bool

    @property
    def speedup(self) -> float:
        return self.record.speedup

    def describe(self) -> str:
        r = self.record
        tag = "store hit" if self.cached else f"{len(self.candidates)} cands"
        return (f"{r.kernel}/{r.backend} {'x'.join(map(str, r.shape))} "
                f"{r.dtype}: best {r.params} "
                f"{r.wall_s*1e6:.1f}us (default {r.default_wall_s*1e6:.1f}us, "
                f"{r.speedup:.2f}x) [{tag}]")


def time_min(fn: Callable[[], object], device: torch.device,
             iters: int = 3, warmup: int = 1) -> float:
    """Least seconds per call of ``fn`` over ``iters`` samples of
    ``time_launches``, after ``warmup`` calls."""
    from repro_torch.kernels.ert.ops import time_launches
    for _ in range(warmup):
        fn()
    return min(time_launches(fn, device, iters=1, warmup=0)
               for _ in range(max(iters, 1)))


def _time_candidate(cand: sp.Candidate, iters: int, warmup: int) -> float:
    """Default timer: build the candidate's operands, then time the call
    with the candidate's own timer where it has one (the GEMM ceiling's,
    which the untuned ceiling is measured with), else :func:`time_min`."""
    from repro_torch.core.profiler import args_device
    fn, args = cand.build()
    dev = args_device(args)
    if cand.timer is not None:
        return cand.timer(lambda: fn(*args), dev)
    return time_min(lambda: fn(*args), dev, iters, warmup)


def search(kernel: str, shape: Sequence[int] | None = None,
           dtype: str = "float32", machine: str = "cpu-host",
           backend: str = "cuda",
           store: TuneStore | str | None = None,
           iters: int = 3, warmup: int = 1, smoke: bool = False,
           force: bool = False,
           timer: Callable[[sp.Candidate, int, int], float] | None = None
           ) -> TuneOutcome:
    """Tune one (kernel, shape, dtype, machine, backend) point.

    ``timer`` replaces the build-and-time of one candidate (tests pass a
    fake); a store hit calls no timer at all.
    """
    if shape is None:
        shape = sp.default_shape(kernel, smoke)
    store = _as_store(store)
    key = tune_key(kernel, shape, dtype, machine, backend)
    if not force:
        hit = store.get(key)
        # a winner of another build of the kernel is timed again
        if hit is not None and current(hit.to_dict()):
            return TuneOutcome(hit, [], cached=True)

    timer = timer or _time_candidate
    cands = sp.candidates(kernel, shape, dtype, backend, smoke)
    results: list[CandidateResult] = []
    for cand in cands:
        wall = float(timer(cand, iters, warmup))
        metric = (cand.work / wall) if wall > 0 else 0.0
        results.append(CandidateResult(
            cand.dict, wall, metric,
            is_default=sp.is_default(kernel, backend, shape, cand.dict)))
    if backend == "cuda":
        torch.cuda.empty_cache()

    best = max(results, key=lambda r: r.metric)
    default = next(r for r in results if r.is_default)
    rec = store.put(make_record(
        kernel, shape, dtype, machine, backend,
        params=best.params, wall_s=best.wall_s, metric=best.metric,
        metric_name=cands[0].metric_name,
        default_wall_s=default.wall_s, default_metric=default.metric,
        n_candidates=len(results)))
    return TuneOutcome(rec, results, cached=False)


def search_all(kernels: Sequence[str] | None = None, *,
               machine: str = "cpu-host", backend: str = "cuda",
               store: TuneStore | str | None = None,
               iters: int = 3, warmup: int = 1, smoke: bool = False,
               force: bool = False, dtype: str = "float32",
               progress: Callable[[str], None] | None = None,
               timer: Callable[[sp.Candidate, int, int], float] | None = None
               ) -> list[TuneOutcome]:
    """Tune every kernel of ``backend`` at its default shape."""
    say = progress or (lambda s: None)
    out = []
    for kernel in (kernels or sp.kernels_for(backend)):
        outcome = search(kernel, dtype=dtype, machine=machine,
                         backend=backend, store=store, iters=iters,
                         warmup=warmup, smoke=smoke, force=force, timer=timer)
        say(outcome.describe())
        out.append(outcome)
    return out


def search_step(config: str = "glm4-9b",
                kernels: Sequence[str] | None = None, *,
                machine: str = "cpu-host", backend: str = "cuda",
                store: TuneStore | str | None = None, seq: int = 16,
                batch: int = 2, amp: str = "O1", full: bool = False,
                n_layers: int | None = None, attn_impl: str = "einsum",
                iters: int = 3, warmup: int = 1, smoke: bool = False,
                force: bool = False, device: str | torch.device = "cuda",
                progress: Callable[[str], None] | None = None,
                timer: Callable[[sp.Candidate, int, int], float] | None = None
                ) -> dict[str, TuneOutcome]:
    """Tune ``kernels`` (default: all of them) at every point where
    ``config``'s train step launches them with the store's winner
    (:func:`repro_torch.tune.dispatch.step_points`; the smoke variant of
    ``config`` unless ``full``), so each winner serves those launches.
    ``smoke`` picks the small candidate grids.  Keyed ``"kernel shape
    dtype"``."""
    from repro_torch.tune.dispatch import step_points
    say = progress or (lambda s: None)
    points = step_points(config, seq=seq, batch=batch, amp=amp,
                         machine=machine, store=store, smoke=not full,
                         n_layers=n_layers, attn_impl=attn_impl,
                         device=device)
    out = {}
    for kernel, shape, dtype in points:
        if kernels is not None and kernel not in kernels:
            continue
        outcome = search(kernel, shape, dtype, machine=machine,
                         backend=backend, store=store, iters=iters,
                         warmup=warmup, smoke=smoke, force=force, timer=timer)
        say(outcome.describe())
        out[f"{kernel} {shape_key(shape)} {dtype}"] = outcome
    return out


def tune_workload(kernels: Sequence[str] | None = None, *,
                  backend: str = "cuda", machine: str = "cpu-host",
                  store: TuneStore | str | None = None,
                  config: str = "glm4-9b", seq: int = 16, batch: int = 2,
                  amp: str = "O1", full: bool = False,
                  n_layers: int | None = None, attn_impl: str = "einsum",
                  ceilings: bool = False, iters: int = 3, warmup: int = 1,
                  smoke: bool = False, force: bool = False,
                  device: str | torch.device = "cuda",
                  progress: Callable[[str], None] | None = None,
                  timer: Callable[[sp.Candidate, int, int], float]
                  | None = None) -> dict[str, TuneOutcome]:
    """Search ``kernels`` (default: all of ``backend``'s but the flash and
    SSD spaces) at the points whose winners something reads:

    * ``space.STEP_KERNELS`` at every (shape, dtype) ``config``'s train
      step launches them at (:func:`search_step`), where their wrappers
      look the winners up;
    * ``space.CEILING_KERNELS`` through :func:`tune_ceilings`, which
      ``characterize(tuned=True)`` reads (also run for ``ceilings`` or
      ``smoke``);
    * ``space.UNREAD_KERNELS`` (flash, SSD) when named, at their standard
      shapes: no launch reads their winners.
    """
    say = progress or (lambda s: None)
    known = sp.kernels_for(backend)
    named = list(kernels or [])
    bad = sorted(set(named) - set(known))
    if bad:
        raise KeyError(f"no {backend} search space for {bad}; "
                       f"valid: {sorted(known)}")
    kernels = named or [k for k in known if k not in sp.UNREAD_KERNELS]
    kw = dict(machine=machine, backend=backend, store=store, iters=iters,
              warmup=warmup, smoke=smoke, force=force, timer=timer)
    out: dict[str, TuneOutcome] = {}
    if set(kernels) & set(sp.STEP_KERNELS):
        out.update(search_step(
            config, kernels, seq=seq, batch=batch, amp=amp, full=full,
            n_layers=n_layers, attn_impl=attn_impl, device=device,
            progress=progress, **kw))
    for kernel in kernels:
        if kernel in sp.UNREAD_KERNELS:
            out[kernel] = search(kernel, **kw)
            say(out[kernel].describe())
    if ceilings or smoke or set(kernels) & set(sp.CEILING_KERNELS):
        out.update(tune_ceilings(progress=progress, **kw))
    return out


# --------------------------------------------------------------------------
# Ceiling searches: the measurements behind characterize(tuned=True)
# --------------------------------------------------------------------------

def ceiling_shapes(smoke: bool = False) -> dict[str, tuple[int, ...]]:
    """Problem sizes of the ceiling searches: the ERT driver's own
    (``ops.FULL`` / ``ops.SMOKE``), so a tuned ceiling and an untuned one
    measure the same work; the triads as (n, reps) — the large one
    HBM-resident, the small one L2-resident."""
    from repro_torch.kernels.ert.ops import FULL, SMOKE
    sz = SMOKE if smoke else FULL
    return {"flops_n": (sz.chain_n,), "gemm": (sz.gemm_ceiling,) * 3,
            "bw_hbm": (sz.hbm_n, sz.hbm_reps),
            "bw_vmem": (sz.l2_n, sz.l2_reps)}


def tune_ceilings(machine: str = "cpu-host",
                  store: TuneStore | str | None = None,
                  iters: int = 3, warmup: int = 1, smoke: bool = False,
                  force: bool = False, backend: str = "torch",
                  progress: Callable[[str], None] | None = None,
                  timer: Callable[[sp.Candidate, int, int], float]
                  | None = None
                  ) -> dict[str, TuneOutcome]:
    """Best-of-tuned ceiling measurements: ``cuda`` spaces on the card,
    ``torch`` spaces on the host.

    Keys: ``flops_f32`` / ``flops_bf16`` (FMA-ladder winners),
    ``gemm_bf16`` (the tensor-core GEMM), ``bw_hbm`` / ``bw_vmem``
    (device-memory- and cache-resident triad).  All persisted: a second
    call is all store hits.
    """
    say = progress or (lambda s: None)
    shapes = ceiling_shapes(smoke)
    kw = dict(machine=machine, store=store, iters=iters, warmup=warmup,
              smoke=smoke, force=force, backend=backend, timer=timer)
    out = {
        "flops_f32": search("fma_chain", shapes["flops_n"],
                            dtype="float32", **kw),
        "flops_bf16": search("fma_chain", shapes["flops_n"],
                             dtype="bfloat16", **kw),
        "gemm_bf16": search("ert_gemm", shapes["gemm"],
                            dtype="bfloat16", **kw),
        "bw_hbm": search("triad", shapes["bw_hbm"], dtype="float32", **kw),
        "bw_vmem": search("triad", shapes["bw_vmem"], dtype="float32", **kw),
    }
    for name, oc in out.items():
        say(f"[{name}] {oc.describe()}")
    return out
