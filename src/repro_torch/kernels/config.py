"""Kernel launch configuration (port of ``repro.kernels.config``).

Same kernel names as the reference, so tune-store keys line up.  Hopper
launch parameters replace the TPU's ``dimension_semantics`` hints:

* ``threads``       — threads per block (for the row-parallel norms: the
  most a row's block may have; a narrow row takes fewer);
* ``blocks_per_sm`` — grid size of a grid-stride or persistent kernel,
  per SM (the triad's must fit the SMs at once: two blocks an SM; the
  norms: the most row blocks launched per SM; each block then walks
  rows with a stride of the grid);
* ``block_m`` / ``block_n`` / ``block_k`` — the tensor-core GEMM's tile,
  a compile-time constant of ``csrc/ert.cu``: the config states it and the
  wrapper refuses any other value;
* ``block_q`` / ``block_k`` — flash attention's query rows per block and
  keys per shared-memory tile, likewise compiled into ``csrc/flash.cu``
  (fp32 at hd > 128 takes 32-key tiles to fit shared memory);
* ``chunk`` — the SSD scan's chunk length (the reference's, an argument
  of the kernel); ``block_q`` / ``block_p`` / ``threads`` — its query and
  key rows per tile, the columns of P per block and the threads of each
  output block, compiled into ``csrc/ssd.cu`` with ``max_chunk`` and
  ``max_state``, the largest chunk and state width the kernel takes.

The reference's ``block_rows`` / ``block`` (rows or elements per VMEM
block) have no counterpart: a Hopper block holds one row, or strides
over the flat leaf, and masks the ragged edge itself.

A wrapper called with no ``config`` launches with :func:`for_launch`:
the tune store's winner for its kernel, shape, dtype and machine
(:func:`best_config`, the reference's ``fused/ops.py::_lookup``), or
the default on a miss.  A winner stamped with another build of its
kernel's library than this one is a miss (``tune/store.py::current``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

KERNELS = ("triad", "fma_chain", "ert_gemm", "flash_attention", "ssd_scan",
           "fused_norm", "fused_swiglu", "fused_adamw")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One kernel's launch parameters (hashable: params as sorted items)."""

    kernel: str
    params: tuple[tuple[str, Any], ...]

    @classmethod
    def make(cls, kernel: str, **params: Any) -> "KernelConfig":
        return cls(kernel, tuple(sorted(params.items())))

    @property
    def dict(self) -> dict[str, Any]:
        return dict(self.params)

    def get(self, name: str, default: Any = None) -> Any:
        return self.dict.get(name, default)

    def replace(self, **params: Any) -> "KernelConfig":
        merged = {**self.dict, **params}
        return KernelConfig(self.kernel, tuple(sorted(merged.items())))


# every kernel of ``KERNELS`` (``fused_norm`` is the entry of both rmsnorm
# kernels and the layernorm, as in the reference)
DEFAULTS: dict[str, KernelConfig] = {
    # the bulk-copy ring takes 96 KiB of shared memory a block: two blocks
    # fill an SM, and a larger grid is refused (``csrc/ert.cu``)
    "triad": KernelConfig.make("triad", threads=256, blocks_per_sm=2),
    "fma_chain": KernelConfig.make("fma_chain", threads=256, blocks_per_sm=8),
    # the tensor-core kernel's tile: two consumer warpgroups of 64 rows x
    # 256 columns, K steps of 64 (the fp32 kernel has its own, compiled
    # alone: ``ert_gemm_tile(3..5)``)
    "ert_gemm": KernelConfig.make("ert_gemm", block_m=128, block_n=256,
                                  block_k=64),
    # one row per block: 256 threads move a 4096-wide bf16 row as two
    # 16-byte vectors each; 16 blocks of 256 fill an SM's 2048 threads
    "fused_norm": KernelConfig.make("fused_norm", threads=256,
                                    blocks_per_sm=16),
    "fused_swiglu": KernelConfig.make("fused_swiglu", threads=256,
                                      blocks_per_sm=8),
    "fused_adamw": KernelConfig.make("fused_adamw", threads=256,
                                     blocks_per_sm=8),
    # the wgmma kernel's tile (16-bit, hd up to 128): a TMA producer and
    # two consumer warpgroups of 64 query rows, 128-key tiles; at hd 128 a
    # block holds 160 KiB of shared memory (Q and 2 stages of K and V), one
    # an SM (the fp32 kernel has its own 64-row tiles, compiled alone)
    "flash_attention": KernelConfig.make("flash_attention", block_q=128,
                                         block_k=128, threads=384),
    # chunk 128 as the reference; 64-row query and key tiles; 64 columns
    # of P a block, so mamba2's P 64 is one block wide; output blocks of
    # 8 warps (128 query rows, two to an SM), chunk blocks of 4 (three)
    "ssd_scan": KernelConfig.make("ssd_scan", chunk=128, block_q=64,
                                  block_p=64, threads=256, max_chunk=256,
                                  max_state=128),
}


def default_config(kernel: str) -> KernelConfig:
    if kernel not in KERNELS:
        raise KeyError(f"unknown kernel {kernel!r}; known: {KERNELS}")
    return DEFAULTS[kernel]


def resolve(kernel: str, config: "KernelConfig | None",
            **overrides: Any) -> KernelConfig:
    """Layer explicit kwargs over ``config`` over the kernel default
    (``None`` overrides mean "not specified")."""
    base = config if config is not None else default_config(kernel)
    if base.kernel != kernel:
        raise ValueError(f"config for {base.kernel!r} passed to {kernel!r}")
    explicit = {k: v for k, v in overrides.items() if v is not None}
    return base.replace(**explicit) if explicit else base


def best_config(kernel: str, shape: tuple[int, ...], dtype: str = "float32",
                machine: str = "cpu-host", *, backend: str = "cuda",
                store=None) -> KernelConfig:
    """The tune store's winner for (kernel, shape, dtype, machine,
    backend), or the kernel's default on a miss."""
    from repro_torch.tune.store import best_config as stored
    return stored(kernel, shape, dtype, machine, backend, store)


def for_launch(kernel: str, config: "KernelConfig | None", t,
               shape: tuple[int, ...]) -> KernelConfig:
    """The config a wrapper launches ``kernel`` with on the CUDA tensor
    ``t``: ``config`` when given, else :func:`best_config` at ``shape`` and
    ``t``'s dtype in the bound tune store, under the bound machine key
    (``repro_torch.tune.store.bind``)."""
    if config is not None:
        return resolve(kernel, config)
    # imported here: the tune store builds on this module
    from repro_torch.tune.store import active_store, machine_for
    return best_config(kernel, tuple(int(s) for s in shape),
                       str(t.dtype).removeprefix("torch."),
                       machine_for(t.device), store=active_store())
