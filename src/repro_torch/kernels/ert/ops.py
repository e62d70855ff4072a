"""ERT driver: machine characterization by measurement (port of
``repro.kernels.ert.ops``; paper §II-A).

The backend follows the device: on ``"cuda"`` every measurement times the
hand-written Hopper kernels (CUDA events around a run of launches, after
warmup; the GEMM's launches replayed from a CUDA graph); on ``"cpu"`` it
times the plain PyTorch versions on the host, which exercises the same
measure → characterize → plot loop.

Sizes are the port's own (:data:`FULL`).  The reference's sizes measure
launch latency on an H100, not ceilings (its cache-resident triad moves
768 KB, about 0.25 µs at HBM speed; its 1024³ GEMM is 2.1 GFLOP, about
2 µs at peak), so each timed launch here is sized to last about 1 ms or
more: an fp32 chain of 2^23 elements × 1024 iterations × 8 chains
(1.4e11 FLOPs); an HBM triad of 3 × 256 MiB repeated 8 times in the
launch; an L2-resident triad of 3 × 8 MiB (24 MiB, inside the 50 MB L2)
repeated 512 times; GEMMs up to 8192³ for the tensor-core ceiling.

``tuned=True`` (the paper's discipline: a ceiling that was not tuned for
is a data point, not a ceiling) takes every ceiling from the best-of-tuned
winners of the ceiling searches (``repro_torch.tune.search.tune_ceilings``:
the ``cuda`` spaces at these sizes on the card, the ``torch`` spaces on
the host), persisted in the tune store, so a second characterization
times nothing.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from repro_torch.core.machine import CPU_HOST, MachineSpec, datasheet_for
from repro_torch.device import resolve_device
from repro_torch.kernels.config import DEFAULTS, KernelConfig
from repro_torch.kernels.ert import bandwidth, flops, gemm


@dataclasses.dataclass(frozen=True)
class ErtSizes:
    """Problem sizes of one characterization."""

    chain_n: int              # fma_chain elements
    chain_iters: int          # dependent FMAs per chain
    hbm_n: int                # triad elements per array, HBM level
    hbm_reps: int             # passes inside one launch
    l2_n: int                 # triad elements per array, on-chip level
    l2_reps: int
    gemm_ceiling: int         # GEMM size for the tensor-core ceiling
    gemm_sweep: tuple[int, ...]
    ladder_gemm: tuple[int, int] = (512, 2048)


FULL = ErtSizes(chain_n=1 << 23, chain_iters=1024, hbm_n=1 << 26, hbm_reps=8,
                l2_n=1 << 21, l2_reps=512, gemm_ceiling=8192,
                gemm_sweep=(256, 512, 1024, 2048, 4096, 8192))
SMOKE = ErtSizes(chain_n=1 << 12, chain_iters=8, hbm_n=1 << 14, hbm_reps=2,
                 l2_n=1 << 10, l2_reps=2, gemm_ceiling=128,
                 gemm_sweep=(128, 256), ladder_gemm=(128, 256))


def time_launches(fn: Callable[[], object], device: torch.device, *,
                  iters: int = 5, warmup: int = 2,
                  min_total_s: float = 0.01) -> float:
    """Mean seconds per call of ``fn`` over back-to-back calls after
    warmup, between two CUDA events on the card (host clock on the host).
    At least ``iters`` calls and at least ``min_total_s`` of work are
    timed, so a launch of a few microseconds is averaged over enough
    launches to see past the clock."""
    cuda = device.type == "cuda"

    def run(k: int) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        return time.perf_counter() - t0

    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    first = run(1)
    k = max(iters, min(10_000, math.ceil(min_total_s / max(first, 1e-9))))
    return run(k) / k


def time_graph(fn: Callable[[], object], device: torch.device, *,
               calls: int | None = None, replays: int = 5,
               samples: int = 1) -> float:
    """Device seconds per call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed ``replays`` times between two CUDA events, so
    the host's cost of a call (the wrapper, the launch) is not timed; the
    least of ``samples`` such means.  ``calls`` defaults to enough for the
    replays to last about 10 ms (2 to 100).  The graph's outputs stay
    allocated until it is freed, one set per captured call."""
    fn()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    if calls is None:
        first = time_launches(fn, device, iters=1, warmup=0, min_total_s=0)
        calls = max(2, min(100, math.ceil(0.01 / replays
                                          / max(first, 1e-9))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = math.inf
    for _ in range(max(samples, 1)):
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        out = min(out, start.elapsed_time(end) / 1e3 / (replays * calls))
    del graph
    torch.cuda.empty_cache()
    return out


def _rand(shape, dtype: torch.dtype, device: torch.device,
          seed: int = 0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device).to(dtype)


def measure_flops(dtype: torch.dtype = torch.float32, n: int = FULL.chain_n,
                  n_iters: int = FULL.chain_iters, ilp: int = 8,
                  device: str | torch.device = "cuda",
                  config: KernelConfig | None = None) -> float:
    """Peak FLOP/s of one precision on the FMA chain (paper Fig 1 ceiling).
    ``config``: the kernel's launch config (default: the tune store's
    winner, else the default)."""
    dev = resolve_device(device)
    x = _rand((n,), dtype, dev)
    t = time_launches(lambda: flops.fma_chain(x, n_iters, ilp,
                                              config=config), dev)
    return flops.fma_flops(n, n_iters, ilp) / t


def measure_bandwidth(dtype: torch.dtype = torch.float32,
                      n: int = FULL.hbm_n, reps: int = FULL.hbm_reps,
                      device: str | torch.device = "cuda",
                      config: KernelConfig | None = None) -> float:
    """Sustained triad bytes/s over ``reps`` passes of ``n`` elements."""
    dev = resolve_device(device)
    a, b = _rand((n,), dtype, dev, 0), _rand((n,), dtype, dev, 1)
    if dev.type == "cuda":
        fn = lambda: bandwidth.triad(a, b, reps=reps, config=config)
    else:
        fn = lambda: [bandwidth.triad(a, b) for _ in range(reps)]
    t = time_launches(fn, dev)
    return bandwidth.triad_bytes(n, a.element_size()) * reps / t


def time_gemm(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds per call of a GEMM ``fn``, as every GEMM ceiling is timed
    (:func:`measure_gemm`, and the ``ert_gemm`` search that the tuned
    ceiling reads): on the card the least of 3 samples of a replayed CUDA
    graph (:func:`time_graph`; at the sweep's small sizes a call's host
    cost is many times the kernel's), on the host :func:`time_launches`."""
    if device.type == "cuda":
        return time_graph(fn, device, samples=3)
    return time_launches(fn, device)


def gemm_operands(m: int, n: int, k: int, dtype: torch.dtype,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (M, K) and (K, N) operands every GEMM ceiling is measured on,
    uniform in [0, 1) from fixed seeds.  The tensor cores' rate under a
    card's power limit may depend on the data
    (``tools/ert_gemm_check.py --data``), so the untuned and the tuned
    ceilings share them."""
    return _rand((m, k), dtype, device, 0), _rand((k, n), dtype, device, 1)


def measure_gemm(dtype: torch.dtype = torch.bfloat16, size: int = 1024,
                 device: str | torch.device = "cuda",
                 config: KernelConfig | None = None) -> float:
    """GEMM FLOP/s at one square size (paper Fig 2 point), on
    :func:`gemm_operands`, timed by :func:`time_gemm`."""
    dev = resolve_device(device)
    a, b = gemm_operands(size, size, size, dtype, dev)
    t = time_gemm(lambda: gemm.matmul(a, b, config=config), dev)
    return gemm.gemm_flops(size, size, size) / t


def gemm_size_sweep(sizes: tuple[int, ...] = FULL.gemm_sweep,
                    dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda") -> dict[int, float]:
    """Paper Fig 2: tensor-core GEMM FLOP/s against matrix size."""
    return {s: measure_gemm(dtype, s, device) for s in sizes}


def ladder(device: str | torch.device = "cuda", sizes: ErtSizes = FULL
           ) -> dict[str, float]:
    """Paper Table I: the precision/tuning ladder, Hopper rungs."""
    n, it = sizes.chain_n, sizes.chain_iters
    g1, g2 = sizes.ladder_gemm
    return {
        "v1 fp32 chain (ilp=1)": measure_flops(torch.float32, n, it, 1, device),
        "v2 fp32 chain (ilp=8)": measure_flops(torch.float32, n, it, 8, device),
        "v3 bf16 packed chain (ilp=8)": measure_flops(torch.bfloat16, n, it,
                                                      8, device),
        f"v4 tensor-core gemm {g1}": measure_gemm(torch.bfloat16, g1, device),
        f"v5 tensor-core gemm {g2}": measure_gemm(torch.bfloat16, g2, device),
    }


def characterize(device: str | torch.device = "cuda", tuned: bool = False,
                 smoke: bool = False, machine: MachineSpec | None = None,
                 store=None) -> MachineSpec:
    """Measured machine model of the device (paper Fig 1, measured).

    Starts from ``machine`` (default: the datasheet spec of the card, or
    ``cpu-host`` on the host) and overwrites the f32 and bf16 ceilings and
    the bandwidth of every memory level; int8/fp8 keep their datasheet
    value (no ERT kernel measures them yet).  ``tuned=True`` takes them
    from the tune store's ceiling winners under ``machine``'s name
    (``store``: a :class:`~repro_torch.tune.store.TuneStore` or a path;
    default the workspace's), searching the ones it lacks.
    """
    dev = resolve_device(device)
    if machine is None:
        machine = (datasheet_for(torch.cuda.get_device_name(dev))
                   if dev.type == "cuda" else CPU_HOST)
    if tuned:
        from repro_torch.tune.search import tune_ceilings
        c = tune_ceilings(machine=machine.name, store=store, smoke=smoke,
                          backend="cuda" if dev.type == "cuda" else "torch")
        peaks = {"f32": c["flops_f32"].record.metric,
                 "bf16": max(c["flops_bf16"].record.metric,
                             c["gemm_bf16"].record.metric)}
        bw = {machine.hbm.name: c["bw_hbm"].record.metric,
              machine.vmem.name: c["bw_vmem"].record.metric}
        return machine.with_empirical(peaks, bw)
    sz = SMOKE if smoke else FULL
    # untuned: the default launch configs, whatever the tune store holds
    fma, triad, mm = (DEFAULTS[k] for k in ("fma_chain", "triad",
                                            "ert_gemm"))
    peaks = {
        "f32": measure_flops(torch.float32, sz.chain_n, sz.chain_iters, 8,
                             dev, fma),
        "bf16": max(measure_flops(torch.bfloat16, sz.chain_n, sz.chain_iters,
                                  8, dev, fma),
                    measure_gemm(torch.bfloat16, sz.gemm_ceiling, dev, mm)),
    }
    bw = {
        machine.hbm.name: measure_bandwidth(torch.float32, sz.hbm_n,
                                            sz.hbm_reps, dev, triad),
        machine.vmem.name: measure_bandwidth(torch.float32, sz.l2_n,
                                             sz.l2_reps, dev, triad),
    }
    return machine.with_empirical(peaks, bw)
