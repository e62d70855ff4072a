"""Search spaces + candidate builders of the kernel autotuner (port of
``repro.tune.space``), for Hopper.

Two backends (the reference's ``pallas`` / ``xla`` split):

* ``cuda`` — the hand-written kernels on the card, over the launch
  parameters they take **at run time**: ``threads`` and ``blocks_per_sm``
  for ``triad``, ``fma_chain``, ``fused_norm``, ``fused_swiglu`` and
  ``fused_adamw``; the (``n_iters``, ``ilp``) ladder of the FMA chain
  (paper §II-A); ``chunk`` for ``ssd_scan``.  The tiles of ``ert_gemm``,
  ``flash_attention`` and ``ssd_scan`` (``block_*``) are compile-time
  constants of ``csrc/`` (``kernels/config.py``), so those spaces hold
  the compiled config alone (the reference searches its Pallas tiles);
* ``torch`` — the plain PyTorch versions on the host, whose ceiling
  searches feed ``characterize(device="cpu", tuned=True)`` (the
  reference's ``xla`` oracle spaces): the FMA ladder, and one candidate
  each for the triad and the GEMM.

Every space holds the default candidate (``kernels/config.py::DEFAULTS``,
clamped to the shape), so a search always yields an honest before
(default) / after (tuned) pair.  The objective is always *maximize
metric*: fixed-work kernels use ``bytes_per_s`` / ``flops_per_s``; the
SSD scan's work varies with ``chunk``, so its metric is ``calls_per_s``.

A triad shape is ``(n,)`` or ``(n, reps)``: ``reps`` passes in one
launch, as the ERT driver times its cache-resident level.  Candidates
build their operands on the backend's device (the card for ``cuda``)
when they are timed, never when the space is listed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels.config import default_config

CUDA_KERNELS = ("triad", "fma_chain", "ert_gemm", "flash_attention",
                "ssd_scan", "fused_norm", "fused_swiglu", "fused_adamw")
TORCH_KERNELS = ("triad", "fma_chain", "ert_gemm")
BACKENDS = ("cuda", "torch")
#: the kernels whose searches are the ceilings of ``characterize``
CEILING_KERNELS = ("triad", "fma_chain", "ert_gemm")
#: kernels whose wrappers launch with the store's winner for the exact
#: (shape, dtype) of the call: searched where a train step launches them
STEP_KERNELS = ("fused_norm", "fused_swiglu", "fused_adamw")
#: kernels whose winners no launch reads: the flash kernel's tiles are
#: compiled (its space is that one config), and the model passes the SSD
#: scan its chunk, which changes the result's rounding; their searches
#: measure the compiled tiles and the chunk
UNREAD_KERNELS = ("flash_attention", "ssd_scan")

#: the FMA ladder's default rung: what ``ops.characterize`` measures on the
#: card (ErtSizes.chain_iters, ilp 8); the host's is the reference's
#: oracle default
CUDA_FMA_DEFAULT = {"n_iters": 1024, "ilp": 8}
TORCH_FMA_DEFAULT = {"n_iters": 256, "ilp": 8}

#: threads an H100 SM holds at once (sm_90's limit)
THREADS_PER_SM = 2048

#: launch-parameter grid of the grid-stride and row kernels
THREADS = (128, 256, 512, 1024)
BLOCKS_PER_SM = (4, 8, 16, 32)
SMOKE_THREADS = (128, 256)
SMOKE_BLOCKS_PER_SM = (8, 16)
#: the triad's: its bulk-copy ring takes 96 KiB of shared memory a block,
#: so an SM holds two, and the kernel refuses a grid the SMs cannot hold
#: at once (``csrc/ert.cu``)
TRIAD_BLOCKS_PER_SM = (1, 2)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a search space, ready to build and time."""

    params: tuple[tuple[str, Any], ...]
    build: Callable[[], tuple[Callable, tuple]]    # () -> (fn, args)
    work: float                                    # per-call work units
    metric_name: str
    #: (call, device) -> seconds per call, in place of the search's own
    #: timing (``search.time_min``); None for that
    timer: Callable[[Callable[[], object], torch.device], float] | None = None

    @property
    def dict(self) -> dict[str, Any]:
        return dict(self.params)

    def label(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.params)


def _cand(params: dict[str, Any], build, work: float,
          metric_name: str, timer=None) -> Candidate:
    return Candidate(tuple(sorted(params.items())), build, work, metric_name,
                     timer)


def default_shape(kernel: str, smoke: bool = False) -> tuple[int, ...]:
    """The shape :func:`~repro_torch.tune.search.search` takes when given
    none (the flash and SSD searches of ``tune_workload`` among them): on
    the card, shapes whose call lasts 0.1 ms or more, so the eager host
    launch does not hide the kernel.  A fused kernel's winner serves only
    its exact shape and dtype, so the workload searches take theirs from
    the train step (``dispatch.step_points``)."""
    full = {
        "triad": (1 << 26, 8),
        "fma_chain": (1 << 23,),
        "ert_gemm": (4096, 4096, 4096),
        "flash_attention": (32, 2048, 2048, 128),
        "ssd_scan": (2, 64, 2048, 64, 128),
        "fused_norm": (16384, 4096),
        "fused_swiglu": (8192, 13696),
        "fused_adamw": (1 << 26,),
    }
    tiny = {
        "triad": (1 << 16,),
        "fma_chain": (1 << 14,),
        "ert_gemm": (256, 256, 256),
        "flash_attention": (2, 256, 256, 64),
        "ssd_scan": (1, 2, 128, 16, 16),
        "fused_norm": (256, 64),
        "fused_swiglu": (256, 128),
        "fused_adamw": (1 << 14,),
    }
    table = tiny if smoke else full
    if kernel not in table:
        raise KeyError(f"unknown kernel {kernel!r}; "
                       f"known: {sorted(table)}")
    return table[kernel]


def default_params(kernel: str, backend: str = "cuda") -> dict[str, Any]:
    """The default candidate's params (the "before" config)."""
    if backend == "torch":
        return dict(TORCH_FMA_DEFAULT) if kernel == "fma_chain" else {}
    p = default_config(kernel).dict
    if kernel == "fma_chain":
        p.update(CUDA_FMA_DEFAULT)
    return p


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name (``"bfloat16"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _device(backend: str) -> torch.device:
    return torch.device("cuda" if backend == "cuda" else "cpu")


def _randn(shape, dtype: torch.dtype, device: torch.device, seed: int = 0,
           scale: float = 1.0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def fit_block(block: int, dim: int) -> int:
    """Largest halving of ``block`` that divides ``dim`` (min 1)."""
    block = min(block, dim)
    while block > 1 and dim % block:
        block //= 2
    return max(block, 1)


def _launch_grid(kernel: str, smoke: bool,
                 blocks_per_sm: Sequence[int] | None = None
                 ) -> list[dict[str, Any]]:
    """threads × blocks_per_sm (the shared grid unless ``blocks_per_sm``
    is given), with the default always in."""
    dflt = default_config(kernel)
    if blocks_per_sm is None:
        blocks_per_sm = SMOKE_BLOCKS_PER_SM if smoke else BLOCKS_PER_SM
    grid = itertools.product(SMOKE_THREADS if smoke else THREADS,
                             blocks_per_sm)
    pairs = dict.fromkeys((*grid, (dflt.get("threads"),
                                   dflt.get("blocks_per_sm"))))
    return [{"threads": t, "blocks_per_sm": b} for t, b in pairs]


def _triad_dims(shape: Sequence[int]) -> tuple[int, int]:
    n, reps = (tuple(shape) + (1,))[:2]
    return int(n), int(reps)


# --------------------------------------------------------------------------
# cuda spaces: the hand-written kernels
# --------------------------------------------------------------------------

def _triad_cuda(shape, dtype, smoke):
    """Only grids the SMs hold at once (``TRIAD_BLOCKS_PER_SM``; the
    kernel refuses a larger one): with ``reps`` > 1 the blocks of a later
    wave would run their passes over their own slice one after another,
    from L2, and an HBM-sized triad would read above the HBM roof."""
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.ert import bandwidth
    n, reps = _triad_dims(shape)
    dt = torch_dtype(dtype)
    work = bandwidth.triad_bytes(n, dt.itemsize) * reps
    out = []
    for params in _launch_grid("triad", smoke, TRIAD_BLOCKS_PER_SM):

        def build(params=params):
            dev = _device("cuda")
            a, b = _randn((n,), dt, dev, 0), _randn((n,), dt, dev, 1)
            cfg = KernelConfig.make("triad", **params)
            return (lambda a_, b_: bandwidth.triad(a_, b_, config=cfg,
                                                   reps=reps)), (a, b)

        out.append(_cand(params, build, work, "bytes_per_s"))
    return out


def _fma_cuda(shape, dtype, smoke):
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.ert import flops as fl
    (n,) = shape
    dt = torch_dtype(dtype)
    ladder = ([(1024, 8)] if smoke
              else [(512, 8), (1024, 4), (1024, 8), (2048, 8)])
    ladder = dict.fromkeys((*ladder, (CUDA_FMA_DEFAULT["n_iters"],
                                      CUDA_FMA_DEFAULT["ilp"])))
    out = []
    for (n_iters, ilp), launch in itertools.product(
            ladder, _launch_grid("fma_chain", smoke)):

        def build(n_iters=n_iters, ilp=ilp, launch=launch):
            x = _randn((n,), dt, _device("cuda"))
            cfg = KernelConfig.make("fma_chain", **launch)
            return (lambda x_: fl.fma_chain(x_, n_iters, ilp, config=cfg)), \
                (x,)

        out.append(_cand({"n_iters": n_iters, "ilp": ilp, **launch}, build,
                         fl.fma_flops(n, n_iters, ilp), "flops_per_s"))
    return out


def _gemm_cuda(shape, dtype, smoke):
    """The compiled tile alone (``csrc/ert.cu``'s constants), on the
    operands and with the timer the untuned ceiling is measured with
    (``ops.gemm_operands``, ``ops.time_gemm``)."""
    from repro_torch.kernels.ert import gemm, ops
    m, n, k = shape
    dt = torch_dtype(dtype)
    cfg = default_config("ert_gemm")

    def build():
        a, b = ops.gemm_operands(m, n, k, dt, _device("cuda"))
        return (lambda a_, b_: gemm.matmul(a_, b_, config=cfg)), (a, b)

    return [_cand(cfg.dict, build, gemm.gemm_flops(m, n, k), "flops_per_s",
                  ops.time_gemm)]


def _flash_cuda(shape, dtype, smoke):
    """The compiled tiles alone (``csrc/flash.cu``'s constants)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    bh, sq, sk, hd = shape
    dt = torch_dtype(dtype)
    cfg = default_config("flash_attention")

    def build():
        dev = _device("cuda")
        q = _randn((bh, sq, hd), dt, dev, 0)
        k = _randn((bh, sk, hd), dt, dev, 1)
        v = _randn((bh, sk, hd), dt, dev, 2)
        return (lambda q_, k_, v_: fa.flash_attention(q_, k_, v_,
                                                      config=cfg)), (q, k, v)

    return [_cand(cfg.dict, build, fa.flops(bh, sq, sk, hd, causal=True),
                  "flops_per_s")]


def _ssd_cuda(shape, dtype, smoke):
    """``chunk``, a run-time argument (up to the compiled ``max_chunk``);
    the tiles are compiled."""
    from repro_torch.kernels.ssd_scan import kernel as ssd
    b, h, s, p, nstate = shape
    dt = torch_dtype(dtype)
    dflt = default_config("ssd_scan")
    chunks = (32, 64, 128) if smoke else (64, 128, 256)
    out = []
    for chunk in dict.fromkeys(fit_block(c, s) for c in
                               (*chunks, dflt.get("chunk"))):

        def build(chunk=chunk):
            dev = _device("cuda")
            x = _randn((b, h, s, p), dt, dev, 0, 0.1)
            a = -_randn((b, h, s), dt, dev, 1, 0.1).abs()
            bm = _randn((b, s, nstate), dt, dev, 2, 0.1)
            cm = _randn((b, s, nstate), dt, dev, 3, 0.1)
            cfg = dflt.replace(chunk=chunk)
            return (lambda x_, a_, b_, c_: ssd.ssd_scan(x_, a_, b_, c_,
                                                        config=cfg)), \
                (x, a, bm, cm)

        out.append(_cand({**dflt.dict, "chunk": chunk}, build, 1.0,
                         "calls_per_s"))
    return out


def _fused_norm_cuda(shape, dtype, smoke):
    """Timed on ``fused_rmsnorm_residual``, as the reference's space (the
    rmsnorm and the layernorm share the entry)."""
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.fused import norm as nk
    rows, d = shape
    dt = torch_dtype(dtype)
    work = nk.hbm_bytes(rows, d, dt.itemsize, residual=True)
    out = []
    for params in _launch_grid("fused_norm", smoke):

        def build(params=params):
            dev = _device("cuda")
            x, h = _randn((rows, d), dt, dev, 0), _randn((rows, d), dt, dev, 1)
            s = torch.ones((d,), dtype=torch.float32, device=dev)
            cfg = KernelConfig.make("fused_norm", **params)
            return (lambda x_, h_, s_: nk.fused_rmsnorm_residual(
                x_, h_, s_, config=cfg)), (x, h, s)

        out.append(_cand(params, build, work, "bytes_per_s"))
    return out


def _fused_swiglu_cuda(shape, dtype, smoke):
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.fused import swiglu as sk
    rows, d = shape
    dt = torch_dtype(dtype)
    work = sk.hbm_bytes(rows, d, dt.itemsize)
    out = []
    for params in _launch_grid("fused_swiglu", smoke):

        def build(params=params):
            dev = _device("cuda")
            g, u = _randn((rows, d), dt, dev, 0), _randn((rows, d), dt, dev, 1)
            cfg = KernelConfig.make("fused_swiglu", **params)
            return (lambda g_, u_: sk.fused_swiglu(g_, u_, config=cfg)), \
                (g, u)

        out.append(_cand(params, build, work, "bytes_per_s"))
    return out


def _fused_adamw_cuda(shape, dtype, smoke):
    """In place, as the train step updates its leaves, through the
    one-leaf call of the multi-tensor kernel: ``shape`` is the size class
    (``adamw.lookup_shape``) of the dtype groups whose launches read the
    winner."""
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.kernels.fused import adamw as ak
    (n,) = shape
    dt = torch_dtype(dtype)
    work = ak.hbm_bytes(n, dt.itemsize)
    out = []
    for params in _launch_grid("fused_adamw", smoke):

        def build(params=params):
            dev = _device("cuda")
            g, p = _randn((n,), dt, dev, 0), _randn((n,), dt, dev, 3)
            m = _randn((n,), dt, dev, 1, 0.1)
            v = _randn((n,), dt, dev, 2, 0.01).abs()
            bc = torch.tensor([0.1, 0.1], device=dev)
            cfg = KernelConfig.make("fused_adamw", **params)
            return (lambda g_, m_, v_, p_, bc_: ak.fused_adamw(
                g_, m_, v_, p_, bc_, inplace=True, config=cfg)), \
                (g, m, v, p, bc)

        out.append(_cand(params, build, work, "bytes_per_s"))
    return out


# --------------------------------------------------------------------------
# torch spaces: the host's ceilings
# --------------------------------------------------------------------------

def _fma_torch(shape, dtype, smoke):
    from repro_torch.kernels.ert import flops as fl
    from repro_torch.kernels.ert import ref
    (n,) = shape
    dt = torch_dtype(dtype)
    grid = ([(64, 4), (64, 8)] if smoke else
            [(ni, il) for ni in (64, 256) for il in (4, 8, 16)])
    out = []
    for n_iters, ilp in dict.fromkeys(
            (*grid, (TORCH_FMA_DEFAULT["n_iters"], TORCH_FMA_DEFAULT["ilp"]))):

        def build(n_iters=n_iters, ilp=ilp):
            x = torch.ones((n,), dtype=dt)
            return (lambda x_: ref.fma_chain_ref(x_, n_iters, ilp)), (x,)

        out.append(_cand({"n_iters": n_iters, "ilp": ilp}, build,
                         fl.fma_flops(n, n_iters, ilp), "flops_per_s"))
    return out


def _triad_torch(shape, dtype, smoke):
    from repro_torch.kernels.ert import bandwidth, ref
    n, reps = _triad_dims(shape)
    dt = torch_dtype(dtype)

    def build():
        a, b = torch.ones((n,), dtype=dt), torch.full((n,), 0.5, dtype=dt)
        return (lambda a_, b_: [ref.triad_ref(a_, b_)
                                for _ in range(reps)]), (a, b)

    return [_cand({}, build, bandwidth.triad_bytes(n, dt.itemsize) * reps,
                  "bytes_per_s")]


def _gemm_torch(shape, dtype, smoke):
    from repro_torch.kernels.ert import gemm, ref
    m, n, k = shape
    dt = torch_dtype(dtype)

    def build():
        dev = torch.device("cpu")
        return ref.matmul_ref, (_randn((m, k), dt, dev, 0),
                                _randn((k, n), dt, dev, 1))

    return [_cand({}, build, gemm.gemm_flops(m, n, k), "flops_per_s")]


_SPACES = {
    ("triad", "cuda"): _triad_cuda,
    ("fma_chain", "cuda"): _fma_cuda,
    ("ert_gemm", "cuda"): _gemm_cuda,
    ("flash_attention", "cuda"): _flash_cuda,
    ("ssd_scan", "cuda"): _ssd_cuda,
    ("fused_norm", "cuda"): _fused_norm_cuda,
    ("fused_swiglu", "cuda"): _fused_swiglu_cuda,
    ("fused_adamw", "cuda"): _fused_adamw_cuda,
    ("triad", "torch"): _triad_torch,
    ("fma_chain", "torch"): _fma_torch,
    ("ert_gemm", "torch"): _gemm_torch,
}


def kernels_for(backend: str) -> tuple[str, ...]:
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; valid: {BACKENDS}")
    return CUDA_KERNELS if backend == "cuda" else TORCH_KERNELS


def candidates(kernel: str, shape: Sequence[int], dtype: str = "float32",
               backend: str = "cuda",
               smoke: bool = False) -> list[Candidate]:
    """The search space of one (kernel, shape, dtype, backend) point; it
    always holds the default candidate (clamped to the shape)."""
    try:
        fn = _SPACES[(kernel, backend)]
    except KeyError:
        raise KeyError(f"no search space for kernel={kernel!r} "
                       f"backend={backend!r}; known: "
                       f"{sorted(set(k for k, _ in _SPACES))}")
    cands = fn(tuple(shape), dtype, smoke)
    dflt = _clamped_default(kernel, backend, shape)
    if not any(c.dict == dflt for c in cands):
        raise AssertionError(
            f"{kernel}/{backend} space must contain the default {dflt}")
    return cands


def _clamped_default(kernel: str, backend: str,
                     shape: Sequence[int]) -> dict[str, Any]:
    """Default params fitted to ``shape``: the SSD chunk halves to a
    divisor of S (the reference's rule); the other defaults run on any
    shape."""
    p = default_params(kernel, backend)
    if backend == "cuda" and kernel == "ssd_scan":
        p["chunk"] = fit_block(p["chunk"], shape[2])
    return p


def is_default(kernel: str, backend: str, shape: Sequence[int],
               params: dict[str, Any]) -> bool:
    return params == _clamped_default(kernel, backend, shape)
