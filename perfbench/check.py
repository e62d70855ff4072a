"""The comparison that decides ``correct``: the program's first train steps
against the plain reference's, on the same weights and batches.

The numbers, each read from two :class:`~perfbench.reference.common.Readings`:

* ``loss_gap``: the largest gap, in nats, between the program's loss
  and the reference's over the followed steps; ``loss1_gap`` the first
  step's alone;
* ``grad_gap``: by the worst leaf, the gap between the norm of the
  program's first gradient (read from its optimizer state after one
  step) and the reference's, over the reference's norm of that leaf or
  of the median leaf, whichever is larger; ``change_gap`` the same for
  each leaf's change over the followed steps;
* ``grad_diff_med``: by the median leaf, the norm of the difference
  between the program's first gradient and the reference's over the
  reference's norm, on the leaf's sampled elements; ``grad_diff_best``
  by the best leaf; ``change_diff_med`` the same for the change;
* ``grad_diff_top_med`` and ``grad_diff_top_worst``: ``grad_diff`` on
  the top layer's slice of each leaf stacked over the layers, by the
  median and by the worst leaf.  That gradient comes through one
  layer's backward (the mixer's, the norms', the MLP's), where a
  stacked leaf's whole gradient also carries every layer above it.

A cell's limits file (``limits/<workload>.json``) names the numbers it
holds and a limit for each.  Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by round-off alone; the
leaf-wise numbers leave them out.
"""

from __future__ import annotations

import math
import statistics

import torch

from perfbench.reference.common import TOP

#: train steps that set-up runs and the reference follows
STEPS = 3
#: a leaf whose first reference gradient is under this share of the
#: median leaf's is left out of the leaf-wise numbers
NEGLIGIBLE = 1e-3

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "change_gap",
           "grad_diff_med", "grad_diff_best", "change_diff_med",
           "grad_diff_top_med", "grad_diff_top_worst")


def _fin(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _norm_gaps(prog: dict[str, float], ref: dict[str, float],
               keep: list[str]) -> dict[str, float]:
    med = statistics.median(ref[k] for k in keep)
    return {k: _fin(abs(prog[k] - ref[k]) / max(ref[k], med)) for k in keep}


def _diffs(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
           keep: list[str]) -> dict[str, float]:
    out = {}
    for k in keep:
        den = float(torch.linalg.vector_norm(ref[k]))
        num = float(torch.linalg.vector_norm(prog[k] - ref[k]))
        out[k] = _fin(num / den) if den > 0 else (0.0 if num == 0
                                                  else math.inf)
    return out


def _worst(gaps: dict[str, float]) -> tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def leaf_numbers(prog, ref) -> dict[str, dict[str, float]]:
    """Per kept leaf: ``grad_gap``, ``change_gap``, ``grad_diff``,
    ``change_diff`` and, of a stacked leaf, ``grad_diff_top``."""
    if set(prog.grad_norms) != set(ref.grad_norms):
        raise ValueError("the program's leaves are not the reference's")
    med = statistics.median(ref.grad_norms.values())
    keep = [k for k, g in ref.grad_norms.items() if g >= NEGLIGIBLE * med]
    top = {k: k + TOP for k in keep if k + TOP in ref.grad_samples}
    tops = _diffs(prog.grad_samples, ref.grad_samples, list(top.values()))
    return {"grad_gap": _norm_gaps(prog.grad_norms, ref.grad_norms, keep),
            "change_gap": _norm_gaps(prog.change_norms, ref.change_norms,
                                     keep),
            "grad_diff": _diffs(prog.grad_samples, ref.grad_samples, keep),
            "change_diff": _diffs(prog.change_samples, ref.change_samples,
                                  keep),
            "grad_diff_top": {k: tops[t] for k, t in top.items()}}


def numbers(prog, ref) -> tuple[dict[str, float], dict[str, str]]:
    """({number: value}, {number: the leaf it was read on})."""
    gaps = [_fin(abs(a - b)) for a, b in zip(prog.losses, ref.losses)]
    if len(prog.losses) != len(ref.losses) or not gaps:
        gaps = [math.inf]
    values = {"loss_gap": max(gaps), "loss1_gap": gaps[0]}
    where = {}
    per = leaf_numbers(prog, ref)
    for name in ("grad_gap", "change_gap"):
        values[name], where[name] = _worst(per[name])
    for name in ("grad_diff", "change_diff"):
        values[name + "_med"] = statistics.median(per[name].values())
    best = min(per["grad_diff"], key=per["grad_diff"].get)
    values["grad_diff_best"], where["grad_diff_best"] = \
        per["grad_diff"][best], best
    tops = per["grad_diff_top"] or {"": math.inf}
    values["grad_diff_top_med"] = statistics.median(tops.values())
    values["grad_diff_top_worst"], where["grad_diff_top_worst"] = \
        _worst(tops)
    return values, where


def judge(values: dict[str, float], limits: dict[str, dict]) -> bool:
    """Every number the limits name finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= lim["limit"]
               for k, lim in limits.items())
