"""Paper Figs 3-7: hierarchical roofline of DeepCAM, per phase and lowering
(port of ``benchmarks/deepcam_roofline.py``).

The paper charts per-kernel (AI, GFLOP/s) points of the forward, backward
and optimizer phases of the TensorFlow and PyTorch DeepCAM.  Here: the
``reference`` and ``fused`` lowerings of the port's DeepCAM, walked op by
op on meta tensors against ``h100-sxm`` at the reference benchmark's size
(stem width 8, (64, 96), batch 2, AMP O1, ``fusion="off"``), with the ASCII
hierarchical roofline, the kernel table and the three-term summary per
phase under ``--verbose``.  ``--full`` walks the real network instead
(width 64, 768×1152); ``--measure`` also times each phase on the device
(the card by default, the host with ``--device cpu``) and puts the
median wall in the ``us_per_call`` column.

The rows have the reference's names.  Its derived checks hold here too:
the backward has more FLOPs than the forward, and the optimizer phase is
memory-bound.  ``conv_flop_share`` (conv and matmul FLOPs over all
FLOPs of the reference lowering's forward) counts other FLOPs than the
reference's: ``jax.image.resize`` lowers to two ``dot_general``\\ s with
dense interpolation matrices, so the reference counts every resize as
matmul FLOPs (2·n_in per output element and channel, along each of the
two axes), where the port's bilinear upsample computes 9 FLOPs per
output element (category ``elementwise``).  ``conv_resize_flop_share``
adds the upsamples back, where the reference's resize dots stand.  At
the default size the reference's share reads 0.97, the port's two 0.97
and 0.98.

Run::

    python -m repro_torch.bench.deepcam_roofline [--device cpu]
        [--full] [--measure] [--verbose]
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

from repro_torch.bench.common import Row, emit

WIDTH, HW, BATCH = 8, (64, 96), 2
IMPLS = ("reference", "fused")
MACHINE = "h100-sxm"


def walk(device: str = "cuda", *, full: bool = False, measure: bool = False
         ) -> tuple[dict, object]:
    """({"<impl>/<phase>": ProfileResult}, machine spec) of both lowerings'
    phases at the benchmark's size (``full``: the real network)."""
    from repro_torch.session.session import Session

    s = Session(machine=MACHINE, device=device)
    results = {}
    for impl in IMPLS:
        prof = s.profile("deepcam", smoke=not full, batch=BATCH, amp="O1",
                         fusion="off", impl=impl, measure=measure, iters=3,
                         warmup=1)
        for phase, res in prof.data.items():
            results[f"{impl}/{phase}"] = res
        del prof
    return results, s.machine


def rows_of(results: dict) -> list[Row]:
    """The reference benchmark's rows from :func:`walk`'s results."""
    rows: list[Row] = []
    for name, res in results.items():
        t = res.terms
        us = res.wall_s * 1e6 if res.wall_s is not None else 0.0
        rows.append((f"deepcam_roofline/{name.replace('/', '_')}", us,
                     f"dom={t.dominant};frac={t.roofline_fraction:.3f};"
                     f"kernels={len(res.analysis.kernels)}"))
    fwd = results["reference/fwd"].analysis
    # paper's headline observations, as derived checks:
    # (1) backward has more FLOPs than forward
    rows.append(("deepcam_roofline/bwd_gt_fwd_flops", 0.0, str(
        results["reference/bwd"].analysis.total_flops > fwd.total_flops)))
    # (2) the optimizer phase is memory-bound streaming (Fig 7)
    rows.append(("deepcam_roofline/opt_memory_bound", 0.0,
                 results["reference/opt"].terms.dominant))
    # (3) conv kernels dominate compute (see the module doc for the resize)
    dense = sum(k.total_flops for k in fwd.kernels
                if k.category in ("conv", "matmul"))
    resize = sum(k.total_flops for k in fwd.kernels
                 if k.opcode == "upsample_bilinear2d")
    rows.append(("deepcam_roofline/conv_flop_share", 0.0,
                 f"{dense / fwd.total_flops:.2f}"))
    rows.append(("deepcam_roofline/conv_resize_flop_share", 0.0,
                 f"{(dense + resize) / fwd.total_flops:.2f}"))
    return rows


def main(device: str = "cuda", *, full: bool = False, measure: bool = False,
         verbose: bool = False) -> list[Row]:
    results, spec = walk(device, full=full, measure=measure)
    if verbose:
        from repro_torch.core.report import (ascii_roofline, kernel_table,
                                             terms_table)
        for name, res in results.items():
            print(ascii_roofline(res.analysis.kernels, spec,
                                 title=f"DeepCAM {name}"))
            print(kernel_table(res.analysis, spec, top_n=8))
        print(terms_table(results))
    return rows_of(results)


def cli(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.deepcam_roofline",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--full", action="store_true",
                    help="width 64 at 768x1152 instead of width 8 at 64x96")
    ap.add_argument("--measure", action="store_true",
                    help="also time each phase on the device")
    ap.add_argument("--verbose", action="store_true",
                    help="charts, kernel tables and the terms table")
    args = ap.parse_args(argv)
    try:
        rows = main(args.device, full=args.full, measure=args.measure,
                    verbose=args.verbose)
    except RuntimeError as e:           # no CUDA device for --device cuda
        print(f"deepcam_roofline: {e}", file=sys.stderr)
        return 2
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
