"""Hand-written Hopper kernels (port of ``repro.kernels``).

Each kernel module keeps a plain-int ``LAUNCHES`` counter that its wrapper
bumps once per launch of the CUDA kernel (never for the plain CPU path).
"""

from __future__ import annotations


def _modules() -> dict:
    from repro_torch.kernels.ert import bandwidth, flops, gemm
    return {"triad": bandwidth, "fma_chain": flops, "ert_gemm": gemm}


def launch_counts() -> dict[str, int]:
    """{kernel name: CUDA launches since the last reset}."""
    return {name: mod.LAUNCHES for name, mod in _modules().items()}


def reset_launch_counts() -> None:
    for mod in _modules().values():
        mod.LAUNCHES = 0
