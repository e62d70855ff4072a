"""Kernel-level benchmark: analytic roofline terms of the hand-written
kernels against the plain chains they replace (port of
``benchmarks/kernel_bench.py``, the §Perf flash-attention / SSD story).

The kernels' HBM traffic is analytic (``kernels/flash_attention/
kernel.py::hbm_bytes`` and ``kernels/ssd_scan/kernel.py::hbm_bytes``, the
reference's models as written: the point of flash and SSD fusion is that
scores never touch HBM).  The plain chain's traffic, which the reference
reads from XLA's compiled HLO, comes from the port's op walk
(``core/op_analysis.py``) of its own chunked attention
(``models/layers.py::_sdpa_chunked``, chunk 512) and of
``models/ssm.py::ssd_chunked``, on meta tensors at the reference's
shapes.  The ratio is the memory-term win the kernel buys where it
replaces the chunk; the memory terms are against the card's datasheet
HBM (the reference's are a TPU's).

The last row times the flash kernel at the reference's (2, 256, 64)
shape.  The reference's row is the Pallas interpreter's fp32 wall; here
it is the hand-written kernel on the card in bf16, its main-path dtype
(the plain version on the host), as ``derived`` says.

Run: ``python -m repro_torch.bench --only kernel_bench [--device cpu]``.
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import Row, datasheet, timed

#: the reference's attention shape: (B, H, S, hd), chunk 512
ATTN = (1, 8, 4096, 128)
ATTN_CHUNK = 512
#: the reference's SSD shape: (B, S, H, P, N), chunk Q
SSD = (1, 2048, 16, 64, 128)
SSD_CHUNK = 128
#: the timed flash row: (BH, S, hd)
FLASH_TIMED = (2, 256, 64)


def attention_bytes() -> tuple[float, float]:
    """(walked bytes of the chunked plain attention, the flash kernel's
    analytic bytes) at :data:`ATTN`, bf16."""
    from repro_torch.core.op_analysis import analyze_fn
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models.layers import _sdpa_chunked

    B, H, S, hd = ATTN
    meta = dict(dtype=torch.bfloat16, device="meta")
    q = torch.empty((B, S, H, 1, hd), **meta)
    k = torch.empty((B, S, H, hd), **meta)
    v = torch.empty((B, S, H, hd), **meta)
    pos = torch.arange(S, device="meta")
    an = analyze_fn(lambda a, b, c, p: _sdpa_chunked(a, b, c, p, p, True,
                                                      ATTN_CHUNK),
                    (q, k, v, pos))
    return an.total_hbm_bytes, FA.hbm_bytes(B * H, S, S, hd)


def ssd_bytes() -> tuple[float, float]:
    """(walked bytes of the plain chunked scan, the SSD kernel's analytic
    bytes) at :data:`SSD`, fp32."""
    from repro_torch.core.op_analysis import analyze_fn
    from repro_torch.kernels.ssd_scan import kernel as SSDK
    from repro_torch.models.ssm import ssd_chunked

    Bs, Ss, Hs, P, N = SSD
    meta = dict(dtype=torch.float32, device="meta")
    xh = torch.empty((Bs, Ss, Hs, P), **meta)
    a = torch.empty((Bs, Ss, Hs), **meta)
    Bc = torch.empty((Bs, Ss, N), **meta)
    Cc = torch.empty((Bs, Ss, N), **meta)
    an = analyze_fn(lambda w, x, y, z: ssd_chunked(w, x, y, z, SSD_CHUNK),
                    (xh, a, Bc, Cc))
    return an.total_hbm_bytes, SSDK.hbm_bytes(Bs, Hs, Ss, P, N)


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import kernel as FA

    dev = resolve_device(device)
    machine = datasheet(dev)
    rows: list[Row] = []

    # --- flash attention against the chunked plain chain ------------------
    walked, kernel_bytes = attention_bytes()
    rows.append(("kernel_bench/attn_xla_hbm_bytes", 0.0,
                 f"{walked/1e9:.2f}GB"))
    rows.append(("kernel_bench/attn_flash_hbm_bytes", 0.0,
                 f"{kernel_bytes/1e9:.4f}GB"))
    rows.append(("kernel_bench/attn_traffic_ratio", 0.0,
                 f"{walked/kernel_bytes:.0f}x"))
    rows.append(("kernel_bench/attn_mem_term_xla_ms", 0.0,
                 f"{walked/machine.hbm.bytes_per_s*1e3:.2f}"))
    rows.append(("kernel_bench/attn_mem_term_flash_ms", 0.0,
                 f"{kernel_bytes/machine.hbm.bytes_per_s*1e3:.4f}"))

    # --- the SSD kernel against the plain chunked scan ---------------------
    walked, kernel_bytes = ssd_bytes()
    rows.append(("kernel_bench/ssd_xla_hbm_bytes", 0.0,
                 f"{walked/1e9:.2f}GB"))
    rows.append(("kernel_bench/ssd_kernel_hbm_bytes", 0.0,
                 f"{kernel_bytes/1e9:.4f}GB"))
    rows.append(("kernel_bench/ssd_traffic_ratio", 0.0,
                 f"{walked/kernel_bytes:.0f}x"))

    # --- the flash kernel's wall at the reference's small shape ------------
    gen = torch.Generator(dev).manual_seed(0)
    qs = torch.randn(FLASH_TIMED, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    us = timed(lambda x: FA.flash_attention(x, x, x), qs, iters=2,
               device=dev)
    how = (f"kernel={FA.route(FLASH_TIMED[-1], qs.dtype)}"
           if dev.type == "cuda" else "plain")
    rows.append(("kernel_bench/flash_interpret_256_us", us,
                 f"dtype=bfloat16;{how}"))
    return rows
