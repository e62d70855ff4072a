"""ERT bandwidth micro-kernel (port of ``repro.kernels.ert.bandwidth``).

STREAM triad ``o = a·s + b``: 3·N·itemsize bytes and 2·N FLOPs, firmly on
the bandwidth roof.  On a CUDA tensor :func:`triad` launches the
hand-written kernel in ``csrc/ert.cu``; on a CPU tensor it runs the plain
version (:func:`repro_torch.kernels.ert.ref.triad_ref`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.ert import ref

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0


def triad(a: torch.Tensor, b: torch.Tensor, scale: float = 3.0, *,
          config: kc.KernelConfig | None = None,
          block: int | None = None, double_buffer: bool | None = None,
          reps: int = 1) -> torch.Tensor:
    """o = a·s + b; bytes = 3·N·itemsize per pass, flops = 2·N.  Any N.

    ``reps`` repeats the pass inside one launch (the result is the same;
    an L2-resident triad needs it to last long enough to time).
    ``block`` and ``double_buffer`` are the TPU kernel's pipeline knobs:
    accepted for signature parity with the reference and ignored — the
    Hopper kernel streams 16 KiB chunks through a ring of bulk copies in
    shared memory, with ``config``'s threads per block and a persistent
    grid of SMs × ``blocks_per_sm`` blocks (``csrc/ert.cu``).  The ring
    takes 96 KiB of shared memory a block, so an SM holds two: a config
    whose grid the SMs cannot hold at once is refused (RuntimeError).
    The blocks claim their chunks from a counter that each call zeroes
    (one memset before the kernel), so calls on different streams share
    nothing.
    """
    global LAUNCHES
    del block, double_buffer
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"triad operands differ: {a.shape}/{a.dtype} vs "
                         f"{b.shape}/{b.dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.triad_ref(a, b, scale)
    cfg = kc.for_launch("triad", config, a,
                        (a.numel(),) if reps == 1 else (a.numel(), reps))
    build.require_cuda(a, b)
    code = build.dtype_code(a)
    out = torch.empty_like(a)
    n = a.numel()
    vec = 16 // a.element_size()
    work = max(n // vec, n % vec, 1)
    threads = int(cfg.get("threads"))
    blocks = max(1, min(build.sm_count(a) * int(cfg.get("blocks_per_sm")),
                        -(-work // threads)))
    counter = torch.zeros(1, dtype=torch.int64, device=a.device)
    lib = build.load("ert")
    err = lib.ert_triad(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                        float(scale), int(reps), code, blocks, threads,
                        counter.data_ptr(), build.stream_of(a))
    build.check(lib, err, "triad")
    LAUNCHES += 1
    return out


def triad_bytes(n_elements: int, itemsize: int) -> float:
    return 3.0 * n_elements * itemsize


def triad_flops(n_elements: int) -> float:
    return 2.0 * n_elements
