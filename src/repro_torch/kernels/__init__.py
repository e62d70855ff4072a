"""Hand-written Hopper kernels (port of ``repro.kernels``).

Each kernel module keeps a plain-int counter (``LAUNCHES``; the norm
module two more, ``RESIDUAL_LAUNCHES`` and ``LAYERNORM_LAUNCHES``, the
flash module ``BWD_LAUNCHES``, one per call of its backward kernel) that
its wrapper bumps once per launch of the CUDA kernel (never for the plain
CPU path).
"""

from __future__ import annotations


def _counters() -> dict:
    """{kernel name: (module, name of its counter)}."""
    from repro_torch.kernels.ert import bandwidth, flops, gemm
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.fused import adamw, norm, swiglu
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return {"triad": (bandwidth, "LAUNCHES"), "fma_chain": (flops, "LAUNCHES"),
            "ert_gemm": (gemm, "LAUNCHES"),
            "fused_rmsnorm": (norm, "LAUNCHES"),
            "fused_rmsnorm_residual": (norm, "RESIDUAL_LAUNCHES"),
            "fused_layernorm": (norm, "LAYERNORM_LAUNCHES"),
            "fused_swiglu": (swiglu, "LAUNCHES"),
            "fused_adamw": (adamw, "LAUNCHES"),
            "flash_attention": (flash, "LAUNCHES"),
            "flash_attention_bwd": (flash, "BWD_LAUNCHES"),
            "ssd_scan": (ssd, "LAUNCHES")}


def launch_counts() -> dict[str, int]:
    """{kernel name: CUDA launches since the last reset}."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
