"""Causal GQA flash-attention forward on Hopper (port of
``repro.kernels.flash_attention.kernel``).

The reference keeps a (BH, S, hd) head's K/V resident in VMEM and sweeps
query blocks over a sequential grid with online-softmax accumulators in
VMEM scratch.  The Hopper kernels (``csrc/flash.cu``) run one block per
(query tile, head, batch) in no order, stream K/V tiles through shared
memory up to the causal diagonal and keep the running max, sum and
accumulator in fp32.  bf16/fp16 take the warp-specialised kernel: a TMA
producer and two ``wgmma`` consumer warpgroups, QKᵀ and PV on the tensor
cores with scores, P and accumulator in registers; fp32 takes plain FMAs
(:func:`route` names the kernel for a head dim and dtype).  Both read the
model layout directly: query head ``h`` reads KV head ``h // G``, so K/V
are never repeated per query head.

* :func:`flash_attention` — the reference's entry point on (BH, S, hd):
  the plain version :func:`~.ref.attention_ref` for CPU tensors, the
  kernel (with H = KV = 1) for CUDA tensors;
* :func:`flash_attention_grouped` — the kernel on the model layout
  q (B, Sq, K, G, hd), k/v (B, Sk, K, hd); CUDA tensors only (its plain
  version is ``ops._ref_gqa``, which the model-facing op runs on the CPU).

Any sequence length runs (the kernel masks the ragged tile); hd must be a
multiple of 8 up to 256.  The kernel's tiles are compile-time constants:
the config states them, the library is held against them once when it
loads, and :func:`flash_attention` refuses any other value.
``DEFAULT_BLOCK_Q/K`` are the reference's TPU blocks, kept because the
chunked route's eligibility (``fused.ops.flash_from_chunked_eligible``)
is defined on them.  ``hbm_bytes`` and ``flops`` are the reference's
roofline model of the kernel, mirrored as written: K/V counted once per
*query* head, causal halving the score area.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.flash_attention.ref import attention_ref

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30

#: dtypes the kernel is compiled for
DTYPES = ("float32", "bfloat16", "float16")
HEAD_DIM_MAX = 256

#: launches of the CUDA kernel (the plain CPU path does not count)
LAUNCHES = 0


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_ndim: int, kv_ndim: int) -> None:
    if q.ndim != q_ndim or k.ndim != kv_ndim or k.shape != v.shape:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash attention dtypes differ: {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")


#: the kernels of ``csrc/flash.cu``, by the code ``flash_route`` returns
ROUTES = ("wgmma", "fp32")

#: (block_q, block_k, threads) compiled into the library, read when it
#: first loads
_COMPILED: tuple[int, int, int] | None = None


def _config_tiles(config: kc.KernelConfig | None = None,
                  block_q: int | None = None,
                  block_k: int | None = None) -> tuple[int, int, int]:
    cfg = kc.resolve("flash_attention", config, block_q=block_q,
                     block_k=block_k)
    return (int(cfg.get("block_q")), int(cfg.get("block_k")),
            int(cfg.get("threads")))


def _library():
    """The ``flash`` library; on its first load its compiled tiles are
    held against the config's defaults."""
    global _COMPILED
    lib = build.load("flash")
    if _COMPILED is None:
        compiled = tuple(lib.flash_tile(i) for i in range(3))
        if compiled != _config_tiles():
            raise RuntimeError(f"csrc/flash.cu is compiled for (block_q, "
                               f"block_k, threads) {compiled}, "
                               f"kernels/config.py states "
                               f"{_config_tiles()}")
        _COMPILED = compiled
    return lib


def route(hd: int, dtype: torch.dtype) -> str:
    """The kernel of :data:`ROUTES` that a launch at head dim ``hd`` in
    ``dtype`` runs (the library's ``flash_route``; loads it)."""
    code = _library().flash_route(hd, build.dtype_code(dtype, DTYPES))
    if code < 0:
        raise ValueError(f"no flash kernel takes hd {hd} in {dtype}")
    return ROUTES[code]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            b: int, sq: int, sk: int, h: int, kv: int, hd: int,
            causal: bool) -> torch.Tensor:
    """Launch on contiguous CUDA operands viewed as q (b, sq, h, hd),
    k/v (b, sk, kv, hd); returns o shaped like q."""
    global LAUNCHES
    if hd % 8 or not 8 <= hd <= HEAD_DIM_MAX:
        raise ValueError(f"flash_attention takes hd a multiple of 8 up to "
                         f"{HEAD_DIM_MAX}, got {hd}")
    if h % kv:
        raise ValueError(f"{h} query heads do not group onto {kv} KV heads")
    if b * sq == 0 or sk == 0:
        raise ValueError("flash_attention needs at least one query and key")
    code = build.dtype_code(q, DTYPES)
    build.require_cuda(q, k, v)
    lib = _library()
    o = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk,
        h, kv, hd, int(bool(causal)), float(hd ** -0.5), code,
        build.stream_of(q))
    build.check(lib, err, "flash_attention")
    LAUNCHES += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    config: kc.KernelConfig | None = None,
                    block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Sk, hd) → (BH, Sq, hd) in q's dtype.

    ``config`` / ``block_q`` / ``block_k`` are the reference's; the tiles
    are compiled in, so any value other than the compiled one raises."""
    _check_operands(q, k, v, 3, 3)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal)
    if (config, block_q, block_k) != (None, None, None):
        want = _config_tiles(config, block_q, block_k)
        _library()
        if want != _COMPILED:
            raise ValueError(f"flash_attention is compiled for (block_q, "
                             f"block_k, threads) {_COMPILED}, config asks "
                             f"for {want}")
    bh, sq, hd = q.shape
    return _launch(q, k, v, bh, sq, int(k.shape[1]), 1, 1, hd, causal)


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True
                            ) -> torch.Tensor:
    """The kernel on the model layout: q (B, Sq, K, G, hd), k/v
    (B, Sk, K, hd) → (B, Sq, K, G, hd); CUDA tensors only."""
    _check_operands(q, k, v, 5, 4)
    b, sq, kv, g, hd = q.shape
    if tuple(k.shape) != (b, k.shape[1], kv, hd):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    return _launch(q, k, v, b, sq, int(k.shape[1]), kv * g, kv, hd, causal)


def hbm_bytes(bh: int, sq: int, sk: int, hd: int, itemsize: int = 2) -> float:
    """Analytic kernel traffic: Q+O once, K+V once per (b, h)."""
    return float(bh) * (2 * sq * hd + 2 * sk * hd) * itemsize


def flops(bh: int, sq: int, sk: int, hd: int, causal: bool = True) -> float:
    """QK^T + PV matmul FLOPs (causal halves the score area)."""
    area = sq * sk / (2 if causal else 1)
    return float(bh) * 2 * 2 * area * hd
