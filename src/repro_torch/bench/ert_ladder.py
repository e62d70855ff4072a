"""Paper Table I: the precision/tuning ladder (port of
``benchmarks/ert_ladder.py``).

The paper's V100 ladder (naive → half2 → u32 index → inline → 29.2 TF)
maps to Hopper rungs (``kernels/ert/ops.py::ladder``): the fp32 FMA chain
at ilp 1, at ilp 8 (latency hidden), the bf16 packed chain, and the
tensor-core GEMM at a small and a large size.  The reference's rungs are
the TPU's (VPU, MXU); the rows here carry the Hopper rungs' names.  On
the card at ``ops.FULL``, on the host (plain versions) at ``ops.SMOKE``.

Run: ``python -m repro_torch.bench --only ert_ladder [--device cpu]``.
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import Row
from repro_torch.device import resolve_device
from repro_torch.kernels.ert import ops as ert


def main(device: str | torch.device = "cuda") -> list[Row]:
    dev = resolve_device(device)
    rungs = ert.ladder(dev, ert.FULL if dev.type == "cuda" else ert.SMOKE)
    rows = [(f"ert_ladder/{name.replace(' ', '_')}", 0.0,
             f"{perf/1e9:.1f}GFLOPs")
            for name, perf in rungs.items()]
    # the ladder should broadly ascend (tolerate noise on neighbours)
    perfs = list(rungs.values())
    rows.append(("ert_ladder/ascends", 0.0, str(perfs[-1] > perfs[0])))
    return rows

