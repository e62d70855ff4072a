"""ERT compute-ceiling micro-kernel (port of ``repro.kernels.ert.flops``).

``ilp`` independent chains of ``n_iters`` dependent ``acc·a + b`` per
element, then summed: (2·n_iters·ilp + ilp)·N FLOPs, so arithmetic
intensity is dialed by ``n_iters`` exactly like ERT's kernel generator.
On a CUDA tensor :func:`fma_chain` launches the hand-written kernel in
``csrc/ert.cu`` (fp32 on the CUDA cores, bf16 packed two to a register);
on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.ert import ref

#: ``ilp`` values compiled into the kernel (a template parameter)
ILPS = (1, 2, 4, 8)

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0


def fma_chain(x: torch.Tensor, n_iters: int = 64, ilp: int = 4, *,
              config: kc.KernelConfig | None = None,
              block: int | None = None) -> torch.Tensor:
    """Run the FLOP micro-kernel; FLOPs = (2·n_iters·ilp + ilp) · x.numel().

    ``block`` is the TPU kernel's tile knob, accepted for signature parity
    and ignored (the Hopper kernel is a grid-stride loop).
    """
    global LAUNCHES
    del block
    if x.device.type == "cpu":
        return ref.fma_chain_ref(x, n_iters, ilp)
    if ilp not in ILPS:
        raise ValueError(f"ilp={ilp} not compiled; compiled: {ILPS}")
    cfg = kc.for_launch("fma_chain", config, x, (x.numel(),))
    build.require_cuda(x)
    code = build.dtype_code(x, ("float32", "bfloat16"))
    out = torch.empty_like(x)
    n = x.numel()
    work = max(n // 2 if x.dtype == torch.bfloat16 else n, 1)
    threads = int(cfg.get("threads"))
    blocks = max(1, min(build.sm_count(x) * int(cfg.get("blocks_per_sm")),
                        -(-work // threads)))
    lib = build.load("ert")
    err = lib.ert_fma_chain(x.data_ptr(), out.data_ptr(), n, int(n_iters),
                            int(ilp), 1.0000001, 1e-7, code, blocks, threads,
                            build.stream_of(x))
    build.check(lib, err, "fma_chain")
    LAUNCHES += 1
    return out


def fma_flops(n_elements: int, n_iters: int, ilp: int) -> float:
    return (2.0 * n_iters * ilp + ilp) * n_elements
