"""Fused gated-MLP activation epilogue: ``act(gate) · up`` in one pass
(port of ``repro.kernels.fused.swiglu``).

Gate and up are read once, the activation runs in fp32, and the product
is written once, rounded to the compute dtype at the write.  ``act`` is
``"silu"`` (SwiGLU: ``g · sigmoid(g)``) or ``"gelu"`` (GeGLU), where gelu
is the tanh approximation — ``jax.nn.gelu``'s default, not
``torch.nn.functional.gelu``'s.

On a CUDA tensor :func:`fused_swiglu` launches the hand-written kernel in
``csrc/fused.cu``; on a CPU tensor it runs the plain version
:func:`swiglu_ref`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.fused import common

ACTS = ("silu", "gelu")
#: FLOPs per element: the activation plus the product with ``up``
_FLOPS = {"silu": 3, "gelu": 10}

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; known: {ACTS}")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (approximate=True), op for op."""
    k = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(k * (x + 0.044715 * (x * x * x)))))


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor, act: str,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: ``act(gate)·up`` in fp32, cast at the end."""
    _check_act(act)
    gf = gate.float()
    h = gf * torch.sigmoid(gf) if act == "silu" else gelu_tanh(gf)
    return (h * up.float()).to(out_dtype)


def fused_swiglu(gate: torch.Tensor, up: torch.Tensor, *, act: str = "silu",
                 out_dtype: torch.dtype | None = None,
                 config: kc.KernelConfig | None = None) -> torch.Tensor:
    """gate/up (rows, d_ff), one dtype → act(gate)·up as ``out_dtype``."""
    global LAUNCHES
    _check_act(act)
    out_dtype = out_dtype or gate.dtype
    common.rows_view(gate)
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError(f"gate {tuple(gate.shape)}/{gate.dtype} and up "
                         f"{tuple(up.shape)}/{up.dtype} differ")
    if gate.device.type == "cpu" and up.device.type == "cpu":
        return swiglu_ref(gate, up, act, out_dtype)
    cfg = kc.for_launch("fused_swiglu", config, gate, tuple(gate.shape))
    build.require_cuda(gate, up, align=1)
    y = torch.empty(gate.shape, dtype=out_dtype, device=gate.device)
    n = gate.numel()
    if n == 0:
        return y
    blocks, threads = common.flat_grid(n, 8, cfg, gate)
    lib = build.load("fused")
    err = lib.fused_swiglu(gate.data_ptr(), up.data_ptr(), y.data_ptr(), n,
                           ACTS.index(act), common.code(gate),
                           common.code(out_dtype), blocks, threads,
                           build.stream_of(gate))
    build.check(lib, err, "fused_swiglu")
    LAUNCHES += 1
    return y


def hbm_bytes(rows: int, d_ff: int, itemsize: int = 2) -> float:
    """Fused traffic: gate + up in, product out."""
    return float(3 * rows * d_ff * itemsize)


def flops(rows: int, d_ff: int, act: str = "silu") -> float:
    """Operations of the plain math as the op walk counts them: silu is a
    logistic and a multiply, the tanh gelu nine operations, and one more
    multiply by ``up``."""
    _check_act(act)
    return float(_FLOPS[act] * rows * d_ff)
