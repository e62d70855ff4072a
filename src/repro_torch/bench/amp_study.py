"""Paper §IV-C, Figs 8-9: the AMP O0 / O1 / O2 study (port of
``benchmarks/amp_study.py``).

For DeepCAM (the paper's case: stem width 8, 64×96, batch 2) and one LM
(``granite-8b``'s smoke config, seq 64, batch 4), the backward pass is
walked on meta tensors under each policy against the card's datasheet
roofline (the reference's is the TPU v5e's): the bf16 share of the
FLOPs (how much compute moved onto the tensor-core ceiling), the bytes
and the roofline bound, and the paper's orderings — O1 moves more than
0.3 of the FLOPs to bf16, and O1's bound is at most 1.05× O0's (the
paper's Fig 9 → Fig 6 move).

Run: ``python -m repro_torch.bench --only amp_study [--device cpu]``.
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import Row, datasheet

#: (row tag, registry config, seq, batch) of the two models
MODELS = (("deepcam", "deepcam", 0, 2), ("lm", "granite-8b", 64, 4))
AMPS = ("O0", "O1", "O2")


def bwd_walks(device: str | torch.device = "cuda") -> dict:
    """{(tag, amp): ProfileResult} of each model's bwd phase."""
    from repro_torch.session.session import Session
    s = Session(machine=datasheet(device), device=device)
    return {(tag, amp): s.profile(config, phases=("bwd",), smoke=True,
                                  seq=seq, batch=batch, amp=amp).data["bwd"]
            for tag, config, seq, batch in MODELS for amp in AMPS}


def main(device: str | torch.device = "cuda") -> list[Row]:
    rows: list[Row] = []
    stats = {}
    for (tag, amp), res in bwd_walks(device).items():
        by_cls = res.analysis.total_flops_by_class
        total = sum(by_cls.values()) or 1.0
        bf16_share = by_cls.get("bf16", 0.0) / total
        stats[(tag, amp)] = (bf16_share, res.analysis.total_hbm_bytes,
                             res.terms.bound_overlap_s)
        rows.append((f"amp_study/{tag}_{amp}", 0.0,
                     f"bf16_share={bf16_share:.2f};"
                     f"bytes={res.analysis.total_hbm_bytes/1e6:.0f}MB;"
                     f"bound={res.terms.bound_overlap_s*1e3:.2f}ms"))
    for tag, *_ in MODELS:
        o0, o1 = stats[(tag, "O0")], stats[(tag, "O1")]
        # paper Fig 9→6: AMP moves compute onto the half-precision ceiling
        rows.append((f"amp_study/{tag}_O1_moves_flops_to_bf16", 0.0,
                     str(o1[0] > o0[0] + 0.3)))
        # and the roofline time bound drops
        rows.append((f"amp_study/{tag}_O1_bound_leq_O0", 0.0,
                     str(o1[2] <= o0[2] * 1.05)))
    return rows
