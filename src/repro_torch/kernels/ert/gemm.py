"""ERT GEMM kernel (port of ``repro.kernels.ert.gemm``; paper §II-A Tensor
Core + Fig 2 size sweep).  FLOPs = 2·M·N·K.

On CUDA tensors :func:`matmul` launches the hand-written kernel in
``csrc/ert.cu``: bf16/fp16 on the tensor cores (``wgmma`` fed by TMA, fp32
accumulator), fp32 on the CUDA cores in full fp32.  On CPU tensors it runs
the plain version.  The tensor-core kernel takes any M, N and K whose rows
are 16-byte aligned (K and N multiples of 8, 16-byte aligned bases): TMA
fills the ragged edge with zeros and the kernel masks its stores.  The fp32
kernel needs its tile to divide the shape, as the reference asserts of
its own.  :func:`check_launch` holds both rules; the wrapper raises on
anything else and never reroutes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.ert import ref

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0

def check_launch(m: int, n: int, k: int, dtype: torch.dtype,
                 f32_tile: tuple[int, int, int],
                 data_ptrs: tuple[int, ...] = (0, 0)) -> None:
    """Raise ``ValueError`` unless the kernel takes an (M, K) @ (K, N)
    product of ``dtype`` operands at ``data_ptrs``: for 16-bit inputs
    (TMA's rules) K % 8 == N % 8 == 0 and 16-byte aligned bases; for fp32
    inputs ``f32_tile``, the fp32 kernel's compiled (block_m, block_n,
    block_k) (``ert_gemm_tile(3..5)``), divides (M, N, K)."""
    if min(m, n, k) <= 0:
        raise ValueError(f"ert_gemm needs a non-empty product, got M={m} "
                         f"N={n} K={k}")
    if dtype == torch.float32:
        bm, bn, bk = f32_tile
        if m % bm or n % bn or k % bk:
            raise ValueError(f"ert_gemm fp32 needs M % {bm} == N % {bn} == "
                             f"K % {bk} == 0, got M={m} N={n} K={k}")
        return
    if k % 8 or n % 8:
        raise ValueError(f"ert_gemm {dtype} needs 16-byte rows (K % 8 == "
                         f"N % 8 == 0), got N={n} K={k}")
    if any(p % 16 for p in data_ptrs):
        raise ValueError("ert_gemm needs 16-byte aligned operands, got data "
                         f"pointers {[hex(p) for p in data_ptrs]}")


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
    build.require_cuda(a, b, align=1)
    lib = build.load("ert")
    tiles = tuple(int(cfg.get(k)) for k in ("block_m", "block_n", "block_k"))
    compiled = tuple(lib.ert_gemm_tile(i) for i in range(3))
    if tiles != compiled:
        raise ValueError(f"ert_gemm is compiled for tiles {compiled}, "
                         f"config asks for {tiles}")
    (m, k), n = a.shape, b.shape[1]
    check_launch(m, n, k, a.dtype,
                 tuple(lib.ert_gemm_tile(i) for i in range(3, 6)),
                 (a.data_ptr(), b.data_ptr()))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = lib.ert_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       build.dtype_code(a), build.dtype_code(out),
                       build.stream_of(a))
    build.check(lib, err, "ert_gemm")
    LAUNCHES += 1
    return out


def gemm_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k
