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
  version is ``ops._ref_gqa_lse``, which the model-facing op runs on the
  CPU).

Any sequence length runs (the kernel masks the ragged tile); hd must be a
multiple of 8 up to 256.  The kernel's tiles are compile-time constants:
the config states them, the library is held against them once when it
loads, and :func:`flash_attention` refuses any other value.
``DEFAULT_BLOCK_Q/K`` are the reference's TPU blocks, kept because the
chunked route's eligibility (``fused.ops.flash_from_chunked_eligible``)
is defined on them.  ``hbm_bytes`` and ``flops`` are the reference's
roofline model of the kernel, mirrored as written: K/V counted once per
*query* head, causal halving the score area.

The forward also writes each query row's log-sum-exp (fp32, (B, H, Sq));
:func:`flash_attention_grouped` returns it beside the output and
:func:`flash_attention_bwd` takes it with the forward's output and the
cotangent and returns dq, dk and dv from four launches (``csrc/flash.cu``'s note), for what
:func:`bwd_route` sends to the kernel: bf16/fp16 with hd a multiple of 8
up to :data:`BWD_HEAD_DIM_MAX`.  ``bwd_flops`` counts its five products.
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

#: calls of the backward kernel (its four launches each; the plain routes
#: do not count)
BWD_LAUNCHES = 0
#: the backward kernel's dtypes and largest head dim
BWD_DTYPES = ("bfloat16", "float16")
BWD_HEAD_DIM_MAX = 128


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
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch on contiguous CUDA operands viewed as q (b, sq, h, hd),
    k/v (b, sk, kv, hd); returns o shaped like q and each row's
    log-sum-exp, (b, h, sq) fp32."""
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
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, sk,
        h, kv, hd, int(bool(causal)), float(hd ** -0.5), code,
        build.stream_of(q))
    build.check(lib, err, "flash_attention")
    LAUNCHES += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    config: kc.KernelConfig | None = None,
                    block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Sk, hd) → (BH, Sq, hd) in q's dtype.

    ``config`` / ``block_q`` / ``block_k`` are the reference's; the tiles
    are compiled in, so any value other than the compiled one raises.
    The kernel's log-sum-exp is dropped here."""
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
    return _launch(q, k, v, bh, sq, int(k.shape[1]), 1, 1, hd, causal)[0]


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the model layout: q (B, Sq, K, G, hd), k/v
    (B, Sk, K, hd) → o (B, Sq, K, G, hd) and each row's log-sum-exp,
    lse (B, K, G, Sq) fp32; CUDA tensors only."""
    _check_operands(q, k, v, 5, 4)
    b, sq, kv, g, hd = q.shape
    if tuple(k.shape) != (b, k.shape[1], kv, hd):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    o, lse = _launch(q, k, v, b, sq, int(k.shape[1]), kv * g, kv, hd,
                     causal)
    return o, lse.view(b, kv, g, sq)


def bwd_route(hd: int, dtype: torch.dtype) -> str:
    """``"kernel"`` where :func:`flash_attention_bwd` takes (hd, dtype) —
    bf16/fp16, hd a multiple of 8 up to :data:`BWD_HEAD_DIM_MAX` — else
    ``"plain"``: the fp32 (O0 parity) path and larger hd keep the plain
    recompute.  Decided from the arguments alone; loads nothing."""
    name = str(dtype).removeprefix("torch.")
    ok = (name in BWD_DTYPES and hd % 8 == 0
          and 8 <= hd <= BWD_HEAD_DIM_MAX)
    return "kernel" if ok else "plain"


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel on the model layout: q, o, dout (B, Sq, K, G,
    hd), k/v (B, Sk, K, hd), lse (B, K, G, Sq) fp32 as the forward wrote
    them → (dq, dk, dv) shaped and typed like q, k, v.  CUDA tensors of
    :func:`bwd_route`'s ``"kernel"`` route only: anything else raises (no
    fallback)."""
    global BWD_LAUNCHES
    _check_operands(q, k, v, 5, 4)
    b, sq, kv, g, hd = q.shape
    sk = int(k.shape[1])
    if tuple(k.shape) != (b, sk, kv, hd) or o.shape != q.shape or \
            dout.shape != q.shape:
        raise ValueError(f"flash backward shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, o {tuple(o.shape)}, dout "
                         f"{tuple(dout.shape)}")
    if tuple(lse.shape) != (b, kv, g, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {kv}, {g}, {sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not q.dtype == o.dtype == dout.dtype:
        raise ValueError(f"flash backward dtypes differ: q {q.dtype}, o "
                         f"{o.dtype}, dout {dout.dtype}")
    if bwd_route(hd, q.dtype) != "kernel":
        raise ValueError(f"the flash backward kernel takes bf16/fp16 with "
                         f"hd a multiple of 8 up to {BWD_HEAD_DIM_MAX}, got "
                         f"hd {hd} in {q.dtype}")
    if b * sq == 0 or sk == 0:
        raise ValueError("flash backward needs at least one query and key")
    build.require_cuda(q, k, v, o, lse, dout)
    code = build.dtype_code(q, BWD_DTYPES)
    lib = _library()
    n = lib.flash_bwd_scratch(b, sq, sk, kv * g, kv, hd)
    if n < 0:
        raise ValueError(f"flash backward refuses q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    scratch = torch.empty(n, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(), b, sq, sk, kv * g, kv, hd,
        int(bool(causal)), float(hd ** -0.5), code, build.stream_of(q))
    build.check(lib, err, "flash_attention_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def hbm_bytes(bh: int, sq: int, sk: int, hd: int, itemsize: int = 2) -> float:
    """Analytic kernel traffic: Q+O once, K+V once per (b, h)."""
    return float(bh) * (2 * sq * hd + 2 * sk * hd) * itemsize


def flops(bh: int, sq: int, sk: int, hd: int, causal: bool = True) -> float:
    """QK^T + PV matmul FLOPs (causal halves the score area)."""
    area = sq * sk / (2 if causal else 1)
    return float(bh) * 2 * 2 * area * hd


def bwd_flops(bh: int, sq: int, sk: int, hd: int,
              causal: bool = True) -> float:
    """The backward's five products (S, dV, dP, dQ, dK): 2.5 x
    :func:`flops`, the work its bound counts (the kernel's dQ pass
    recomputes S and dP on top: 7 products run)."""
    return 2.5 * flops(bh, sq, sk, hd, causal)
