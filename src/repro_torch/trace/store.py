"""Phase payloads in the trace-store schema (port of the payload half of
``repro.trace.store``).  The JSONL store itself comes with ``record``
(ROADMAP queue 1, item 8); the payload keys are the reference's, so its
readers take the port's payloads unchanged.  The on-chip level's bytes
travel under ``vmem_bytes`` as in the reference schema.
"""

from __future__ import annotations

from typing import Any

from repro_torch.trace.collector import PhaseMeasurement

# phase-payload metric keys every record carries (compare iterates these)
PHASE_METRICS = ("wall_s", "achieved_flops_per_s", "pct_of_roofline",
                 "bound_overlap_s", "bound_serial_s")


def phase_payload(m: PhaseMeasurement, top_kernels: int = 8
                  ) -> dict[str, Any]:
    """Serializable per-phase metrics, with whole-phase launch totals
    (paper Table III census) over every kernel."""
    t = m.terms
    launches = sum(k.exec_count for k in m.kernels)
    zero_ai = sum(k.exec_count for k in m.kernels if not k.flops)
    scatter = sum(k.exec_count for k in m.kernels
                  if "scatter" in k.name.lower())
    return {
        "launches": launches,
        "zero_ai_launches": zero_ai,
        "scatter_launches": scatter,
        "wall_s": m.wall_s,
        "iters": m.iters,
        "achieved_flops_per_s": m.achieved_flops_per_s,
        "pct_of_roofline": m.pct_of_roofline,
        "bound_overlap_s": m.bound_overlap_s,
        "bound_serial_s": m.bound_serial_s,
        "compute_s": t.compute_s,
        "memory_s": t.memory_s,
        "collective_s": t.collective_s,
        "dominant": m.dominant,
        "flops": m.flops,
        "hbm_bytes": m.hbm_bytes,
        "vmem_bytes": m.vmem_bytes,
        "ici_bytes": t.ici_wire_bytes,
        "dcn_bytes": t.dcn_wire_bytes,
        "net_bytes": t.ici_wire_bytes + t.dcn_wire_bytes,
        "ici_bound_s": t.collective_ici_s,
        "dcn_bound_s": t.collective_dcn_s,
        "kernels": [
            {"name": k.name, "category": k.category,
             "exec_count": k.exec_count,
             "flops": k.flops, "hbm_bytes": k.hbm_bytes,
             "vmem_bytes": k.vmem_bytes,
             "ai_hbm": k.ai_hbm, "bound_s": k.bound_s,
             "attributed_s": k.attributed_s,
             "achieved_flops_per_s": k.achieved_flops_per_s,
             "pct_of_roofline": k.pct_of_roofline}
            for k in m.kernels[:top_kernels]
        ],
    }
