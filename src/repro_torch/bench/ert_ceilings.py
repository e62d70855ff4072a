"""Paper Fig 1: multi-precision machine ceilings (port of
``benchmarks/ert_ceilings.py``).

Three panels:

* the **datasheet** ceilings of the card (``core/machine.py``'s H100
  spec; on the host the H100 SXM's): one row per precision class and
  memory level, and the interconnect;
* the **empirical default** ceilings: the ERT kernels at their default
  launch configs (``kernels/ert/ops.py``) — on the card at the ERT driver's
  full sizes (``ops.FULL``) with the GEMM at 512³, on the host their
  plain versions at ``ops.SMOKE``;
* the **empirical tuned** ceilings: the ceiling searches' winners from
  the workspace's tune store (``tune_ceilings``; a second run is all
  store hits), with each search's default against its winner at the
  same shape.

Run: ``python -m repro_torch.bench --only ert_ceilings [--device cpu]``.
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import Row, datasheet
from repro_torch.core.machine import CPU_HOST
from repro_torch.device import resolve_device
from repro_torch.kernels.config import DEFAULTS
from repro_torch.kernels.ert import ops as ert


def main(device: str | torch.device = "cuda") -> list[Row]:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sheet = datasheet(dev)
    rows: list[Row] = []
    # datasheet panel
    for cls, peak in sheet.peak_flops.items():
        rows.append((f"ert_ceilings/datasheet_{cls}", 0.0,
                     f"{peak/1e12:.1f}TFLOPs"))
    for lv in sheet.mem_levels:
        rows.append((f"ert_ceilings/datasheet_{lv.name}_bw", 0.0,
                     f"{lv.bytes_per_s/1e9:.0f}GB/s"))
    rows.append(("ert_ceilings/datasheet_ici_bw", 0.0,
                 f"{sheet.ici_bytes_per_s*sheet.ici_links/1e9:.0f}GB/s"))

    # empirical default panel: the default launch configs
    sz = ert.FULL if cuda else ert.SMOKE
    fma, triad, mm = (DEFAULTS[k] for k in ("fma_chain", "triad",
                                            "ert_gemm"))
    f32 = ert.measure_flops(torch.float32, sz.chain_n, sz.chain_iters, 8,
                            dev, fma)
    bf16 = ert.measure_flops(torch.bfloat16, sz.chain_n, sz.chain_iters, 8,
                             dev, fma)
    gemm = ert.measure_gemm(torch.bfloat16, 512, dev, mm)
    hbm = ert.measure_bandwidth(torch.float32, sz.hbm_n, sz.hbm_reps, dev,
                                triad)
    llc = ert.measure_bandwidth(torch.float32, sz.l2_n, sz.l2_reps, dev,
                                triad)
    rows += [
        ("ert_ceilings/empirical_f32_chain", 0.0, f"{f32/1e9:.1f}GFLOPs"),
        ("ert_ceilings/empirical_bf16_chain", 0.0, f"{bf16/1e9:.1f}GFLOPs"),
        ("ert_ceilings/empirical_gemm512", 0.0, f"{gemm/1e9:.1f}GFLOPs"),
        ("ert_ceilings/empirical_dram_bw", 0.0, f"{hbm/1e9:.1f}GB/s"),
        ("ert_ceilings/empirical_cache_bw", 0.0, f"{llc/1e9:.1f}GB/s"),
    ]

    # empirical tuned panel: the ceiling searches' winners (store hits
    # after the first run) and each search's default against its winner
    from repro_torch.tune.search import tune_ceilings
    machine = sheet if cuda else CPU_HOST
    ceil = tune_ceilings(machine=machine.name, smoke=not cuda,
                         backend="cuda" if cuda else "torch")
    spec = ert.characterize(dev, tuned=True, smoke=not cuda,
                            machine=machine)
    rows += [
        ("ert_ceilings/tuned_f32", 0.0,
         f"{spec.peak_flops['f32']/1e9:.1f}GFLOPs"),
        ("ert_ceilings/tuned_bf16", 0.0,
         f"{spec.peak_flops['bf16']/1e9:.1f}GFLOPs"),
        ("ert_ceilings/tuned_dram_bw", 0.0,
         f"{spec.hbm.bytes_per_s/1e9:.1f}GB/s"),
        ("ert_ceilings/tuned_cache_bw", 0.0,
         f"{spec.vmem.bytes_per_s/1e9:.1f}GB/s"),
    ]
    for name in ("flops_f32", "flops_bf16", "gemm_bf16"):
        r = ceil[name].record
        before = r.default_metric / r.metric if r.metric else 1.0
        rows.append((f"ert_ceilings/frac_of_peak_{name}_before_after", 0.0,
                     f"{before:.2f}->1.00"))
    return rows

