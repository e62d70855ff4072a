"""Launch plumbing shared by the fused kernels (port of
``repro.kernels.fused.common``).

The reference's ``row_blocked_call`` sweeps VMEM blocks of ``block_rows``
rows over a 1D grid and zero-pads the last block.  On Hopper a row kernel
runs one block per row (striding over rows when there are more rows than
blocks), and an elementwise kernel strides over the flat view; both mask
the ragged edge themselves, so any row count and any length run with no
padding copied through device memory.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc

#: the dtypes the fused kernels are compiled for
FLOAT_DTYPES = ("float32", "bfloat16")


def code(t) -> int:
    """The C interface's dtype code of a tensor or dtype (f32 or bf16)."""
    return build.dtype_code(t, FLOAT_DTYPES)


def rows_view(x: torch.Tensor) -> tuple[int, int]:
    """(rows, d) of a 2D ``(rows, d)`` operand; raises on anything else."""
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"expected a 2D (rows, d) operand with d > 0, got "
                         f"shape {tuple(x.shape)}")
    return int(x.shape[0]), int(x.shape[1])


def row_grid(rows: int, d: int, cfg: kc.KernelConfig,
             t: torch.Tensor) -> tuple[int, int]:
    """(blocks, threads) of a one-row-per-block kernel on ``t``'s card:
    enough warps to cover a row in 8-element chunks, at most ``threads``;
    at most ``blocks_per_sm`` blocks per SM, each then striding over
    rows."""
    chunks = -(-d // 8)
    threads = min(int(cfg.get("threads")), max(32, (chunks + 31) // 32 * 32))
    blocks = max(1, min(rows, build.sm_count(t) * int(cfg.get("blocks_per_sm"))))
    return blocks, threads


def flat_grid(n: int, per_thread: int, cfg: kc.KernelConfig,
              t: torch.Tensor) -> tuple[int, int]:
    """(blocks, threads) of a grid-stride kernel on ``t``'s card over ``n``
    elements taken ``per_thread`` at a time."""
    threads = int(cfg.get("threads"))
    work = max(1, -(-n // per_thread))
    blocks = max(1, min(build.sm_count(t) * int(cfg.get("blocks_per_sm")),
                        -(-work // threads)))
    return blocks, threads
