"""ERT GEMM kernel (port of ``repro.kernels.ert.gemm``; paper §II-A Tensor
Core + Fig 2 size sweep).  FLOPs = 2·M·N·K.

On CUDA tensors :func:`matmul` launches the hand-written kernel in
``csrc/ert.cu``: bf16/fp16 on the tensor cores (wmma, fp32 accumulator),
fp32 on the CUDA cores in full fp32.  On CPU tensors it runs the plain
version.  As the reference asserts its tiles divide the shape, the
wrapper raises unless M and N are multiples of the block tile and K of
the K step.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.ert import ref

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           config: kc.KernelConfig | None = None,
           block_m: int | None = None, block_n: int | None = None,
           block_k: int | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B with an fp32 accumulator, cast to ``out_dtype`` (default
    ``a.dtype``)."""
    global LAUNCHES
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"matmul dtypes differ: {a.dtype} vs {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype)
    cfg = kc.resolve("ert_gemm", kc.for_launch(
        "ert_gemm", config, a, (a.shape[0], b.shape[1], a.shape[1])),
        block_m=block_m, block_n=block_n, block_k=block_k)
    build.require_cuda(a, b)
    lib = build.load("ert")
    tiles = tuple(int(cfg.get(k)) for k in ("block_m", "block_n", "block_k"))
    compiled = tuple(lib.ert_gemm_tile(i) for i in range(3))
    if tiles != compiled:
        raise ValueError(f"ert_gemm is compiled for tiles {compiled}, "
                         f"config asks for {tiles}")
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = tiles
    if m % bm or n % bn or k % bk:
        raise ValueError(f"ert_gemm needs M % {bm} == N % {bn} == K % {bk} "
                         f"== 0, got M={m} N={n} K={k}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = lib.ert_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       build.dtype_code(a), build.dtype_code(out),
                       build.stream_of(a))
    build.check(lib, err, "ert_gemm")
    LAUNCHES += 1
    return out


def gemm_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k
