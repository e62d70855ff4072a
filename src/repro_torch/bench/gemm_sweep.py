"""Paper Fig 2 + Eq 3: GEMM performance against matrix size (port of
``benchmarks/gemm_sweep.py``).

The paper sweeps M = N = K for WMMA against cuBLAS under the 107.5 TF
Tensor-Core peak of its Eq 3.  Here, on the card: the hand-written
``ert_gemm`` (``kernels/csrc/ert.cu``, bf16 on the tensor cores) and
``torch.matmul`` (the library GEMM) at each size of ``ops.FULL`` on the
ceiling's operands, timed alike (``ops.time_gemm``); the kernel's fp32
product at 256³ against ``matmul_ref``; and Eq 3 for Hopper.  On the
host the plain versions at ``ops.SMOKE``'s sizes.

Rows keep the reference's names where they are not the TPU's: its
``xla_<size>`` (the library GEMM) is ``torch_matmul_<size>`` beside the
kernel's ``ert_gemm_<size>``; its Pallas kernel's
``pallas_vs_ref_maxerr`` / ``pallas_config`` are ``ert_gemm_...``; its
``eq3_v5e_peak`` (4 MXUs × 128² PEs × 2 × 0.94 GHz) is
``eq3_h100_peak``: SMs × 4 tensor cores an SM × 1024 dense bf16 FLOP a
clock each × the max SM clock (``nvidia-smi --query-gpu=clocks.max.sm``),
printed beside the datasheet's bf16 peak (on the host the H100 SXM's
132 SMs and 1980 MHz).

Run: ``python -m repro_torch.bench --only gemm_sweep [--device cpu]``.
"""

from __future__ import annotations

import subprocess

import torch

from repro_torch.bench.common import Row, datasheet
from repro_torch.device import resolve_device
from repro_torch.kernels.ert import gemm, ops as ert, ref

#: Hopper (sm_90): tensor cores an SM, dense bf16 FLOPs a clock each
TENSOR_CORES_PER_SM = 4
BF16_FLOP_PER_CLOCK = 1024
#: the H100 SXM's SMs and max SM clock (MHz), for the host's Eq 3 row
H100_SXM_SMS, H100_SXM_MAX_MHZ = 132, 1980


def eq3_peak(device: torch.device) -> tuple[float, int, float]:
    """(Eq 3 bf16 peak FLOP/s, SMs, max SM clock in MHz) of the card."""
    if device.type != "cuda":
        sms, mhz = H100_SXM_SMS, float(H100_SXM_MAX_MHZ)
    else:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60, check=True)
        mhz = float(out.stdout.split()[0])
    return sms * TENSOR_CORES_PER_SM * BF16_FLOP_PER_CLOCK * mhz * 1e6, \
        sms, mhz


def main(device: str | torch.device = "cuda") -> list[Row]:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sheet = datasheet(dev)
    rows: list[Row] = []
    eq3, sms, mhz = eq3_peak(dev)
    rows.append(("gemm_sweep/eq3_h100_peak", 0.0,
                 f"{eq3/1e12:.1f}TFLOPs;sms={sms};max_sm_clock={mhz:.0f}MHz;"
                 f"datasheet_bf16={sheet.peak_flops['bf16']/1e12:.1f}TFLOPs"))

    sizes = (ert.FULL if cuda else ert.SMOKE).gemm_sweep
    sweep = ert.gemm_size_sweep(sizes, device=dev)
    for size, perf in sweep.items():
        a, b = ert.gemm_operands(size, size, size, torch.bfloat16, dev)
        lib = gemm.gemm_flops(size, size, size) / ert.time_gemm(
            lambda: torch.matmul(a, b), dev)
        del a, b
        rows.append((f"gemm_sweep/ert_gemm_{size}", 0.0,
                     f"{perf/1e9:.1f}GFLOPs"))
        rows.append((f"gemm_sweep/torch_matmul_{size}", 0.0,
                     f"{lib/1e9:.1f}GFLOPs"))
    # monotone-ish rise with size (the paper's headline shape)
    perfs = list(sweep.values())
    rows.append(("gemm_sweep/rises_with_size", 0.0,
                 str(perfs[-1] > perfs[0])))

    # the kernel's fp32 product against the plain version at one size,
    # with the config the store gives it (the default without a winner)
    from repro_torch.tune.store import config_source, machine_for
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn((256, 256), generator=g, device=dev)
    b = torch.randn((256, 256), generator=g, device=dev)
    source, cfg = config_source("ert_gemm", (256, 256, 256), "float32",
                                machine_for(dev),
                                "cuda" if cuda else "torch")
    out = gemm.matmul(a, b)
    want = ref.matmul_ref(a, b)
    err = float((out - want).abs().max())
    rows.append(("gemm_sweep/ert_gemm_vs_ref_maxerr", 0.0,
                 f"{err:.2e};max_ref={float(want.abs().max()):.4g}"))
    label = ",".join(f"{k}={v}" for k, v in sorted(cfg.dict.items()))
    rows.append(("gemm_sweep/ert_gemm_config", 0.0, f"{source}:{label}"))
    return rows
