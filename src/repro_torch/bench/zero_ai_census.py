"""Paper Table III: zero-AI kernel launches per phase and lowering (port
of ``benchmarks/zero_ai_census.py``).

The paper counts the kernel launches that do no FLOPs (type converts,
layout moves, copies): 40-55% of all launches in both frameworks.  Here
the same census over the port's op walk (``core/op_analysis.py``), on
meta tensors, twice:

* DeepCAM's ``reference`` against its ``fused`` lowering (the paper's
  TF-against-PyTorch analogue), fwd and bwd at AMP O1 — at the
  reference's benchmark size (stem width 8, 64×96, batch 2), or with
  ``full`` at the paper's (width 64, 768×1152);
* an LM train step (fwd / bwd / opt of ``glm4-9b``'s smoke config, seq
  64, batch 4, O1) at ``fusion`` ``off`` against ``static`` — the fused
  kernels target exactly the chains the census ranks hottest.

Row names are the reference's.  The walk allocates nothing, so the
device only names where the suite runs.

Run: ``python -m repro_torch.bench --only zero_ai_census [--full]``.
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import Row

LM_CONFIG = "glm4-9b"
LM_SEQ = 64
LM_BATCH = 4
MACHINE = "h100-sxm"

# "static" (not "auto"): the census counts what full static fusion
# removes; measured dispatch would consult the tune store mid-walk.  The
# row tag stays "fused", as the reference's.
FUSION_MODES = ("off", "static")
_MODE_TAG = {"off": "reference", "static": "fused"}


def _session(device: str | torch.device):
    from repro_torch.session.session import Session
    return Session(machine=MACHINE, device=device)


def deepcam_census(census_by: dict, *, full: bool = False,
                   device: str | torch.device = "cuda") -> list[Row]:
    """Reference-against-fused DeepCAM lowerings (the paper's TF against
    PyTorch), AMP O1, batch 2."""
    s = _session(device)
    rows: list[Row] = []
    for impl in ("reference", "fused"):
        prof = s.profile("deepcam", phases=("fwd", "bwd"), smoke=not full,
                         batch=2, amp="O1", impl=impl)
        for phase in ("fwd", "bwd"):
            census = prof.analyses[phase].zero_ai_census()
            census_by[f"{impl}/{phase}"] = census
            z, n = census["zero-AI"][0], census["non zero-AI"][0]
            rows.append((f"zero_ai/{impl}_{phase}", 0.0,
                         f"zero={z};nonzero={n};frac={z/(z+n):.2f}"))
    zr = sum(census_by[f"reference/{p}"]["zero-AI"][0]
             for p in ("fwd", "bwd"))
    zf = sum(census_by[f"fused/{p}"]["zero-AI"][0] for p in ("fwd", "bwd"))
    rows.append(("zero_ai/reference_vs_fused", 0.0, f"{zr}vs{zf}"))
    return rows


def lm_phase_census(config: str = LM_CONFIG, seq: int = LM_SEQ,
                    batch: int = LM_BATCH,
                    device: str | torch.device = "cuda"
                    ) -> dict[str, dict[str, tuple[int, int]]]:
    """{"off/fwd": census, ..., "static/opt": census} for one LM config's
    smoke train step."""
    s = _session(device)
    out: dict[str, dict[str, tuple[int, int]]] = {}
    for fusion in FUSION_MODES:
        prof = s.profile(config, smoke=True, seq=seq, batch=batch,
                         amp="O1", fusion=fusion)
        for phase, ana in prof.analyses.items():
            out[f"{fusion}/{phase}"] = ana.zero_ai_census()
    return out


def lm_totals(census_by: dict, fusion: str) -> tuple[int, int]:
    """(zero-AI launches, total launches) across the train-step phases."""
    zero = total = 0
    for key, census in census_by.items():
        if not key.startswith(f"{fusion}/"):
            continue
        z, n = census["zero-AI"][0], census["non zero-AI"][0]
        zero += z
        total += z + n
    return zero, total


def lm_step_summary(census_by: dict) -> dict[str, float]:
    """Train-step totals and the zero-AI reduction fraction."""
    z_ref, n_ref = lm_totals(census_by, "off")
    z_fus, n_fus = lm_totals(census_by, "static")
    return {"zero_ref": z_ref, "launches_ref": n_ref,
            "zero_fused": z_fus, "launches_fused": n_fus,
            "zero_reduction": 1.0 - z_fus / z_ref if z_ref else 0.0}


def lm_census_rows(config: str = LM_CONFIG, seq: int = LM_SEQ,
                   batch: int = LM_BATCH, census_sink: dict | None = None,
                   device: str | torch.device = "cuda") -> list[Row]:
    """Per-phase reference-against-fused rows and the train-step delta."""
    census_by = lm_phase_census(config, seq, batch, device)
    if census_sink is not None:
        census_sink.update({f"lm/{k}": v for k, v in census_by.items()})
    rows: list[Row] = []
    for key, census in census_by.items():
        fusion, phase = key.split("/")
        z, n = census["zero-AI"][0], census["non zero-AI"][0]
        rows.append((f"zero_ai/lm_{phase}_{_MODE_TAG[fusion]}", 0.0,
                     f"zero={z};nonzero={n};frac={z/(z+n):.2f}"))
    for phase in ("fwd", "bwd", "opt"):
        zr = census_by[f"off/{phase}"]["zero-AI"][0]
        zf = census_by[f"static/{phase}"]["zero-AI"][0]
        rows.append((f"zero_ai/lm_{phase}_delta", 0.0, f"{zr}vs{zf}"))
    s = lm_step_summary(census_by)
    rows.append(("zero_ai/lm_step_reference_vs_fused", 0.0,
                 f"zero={s['zero_ref']}vs{s['zero_fused']};"
                 f"launches={s['launches_ref']}vs{s['launches_fused']};"
                 f"zero_reduction={s['zero_reduction']:.2f}"))
    return rows


def main(device: str | torch.device = "cuda", *, full: bool = False,
         verbose: bool = False) -> list[Row]:
    rows: list[Row] = []
    census_by: dict = {}
    rows.extend(deepcam_census(census_by, full=full, device=device))
    rows.extend(lm_census_rows(census_sink=census_by, device=device))
    if verbose:
        from repro_torch.core.report import zero_ai_table
        print(zero_ai_table(census_by))
    return rows
