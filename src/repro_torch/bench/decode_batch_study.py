"""decode_batch_study: decode tokens/s at the roofline bound against the
global batch (port of ``benchmarks/decode_batch_study.py``).

Every decode cell reads the whole weights and cache for one token per
sequence, so its roofline fraction is near 0; batch is the lever.  This
walks glm4-9b's ``decode_32k`` step on the single-pod dry-run mesh
(``launch.dryrun.run_cell``, per device, on the ``h100-sxm`` datasheet
spec) at growing global batch: compute and cache traffic grow with the
batch, weight traffic does not.

Each batch's analytical profile becomes a trace-schema phase payload
(``decode_b<gb>``); all of them land as one ``serve/decode_batch/<arch>``
:class:`~repro_torch.trace.store.TraceRecord` in the workspace's trace
store, and the rows are read back from the stored payloads, as the
reference does.  The row's ``us_per_call`` is the perfect-overlap bound
of one decode step; the last row is the amortization summary.

Run: ``python -m repro_torch.bench --only decode_batch_study`` (the full
``BATCHES``) or ``python -m repro_torch.bench.decode_batch_study
[--smoke]`` (``SMOKE_BATCHES``).
"""

from __future__ import annotations

import sys

import torch

from repro_torch.bench.common import Row

BATCHES = (32, 128, 512, 2048)
SMOKE_BATCHES = (32, 128)
ARCH = "glm4-9b"
MACHINE = "h100-sxm"
SEQ = 32_768


def study_record(batches=BATCHES, arch: str = ARCH, cfg=None):
    """One TraceRecord: phase ``decode_b<gb>`` per batch (serve schema).
    ``cfg`` stands in for the registry's config (a cut depth)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import release_fake_group
    from repro_torch.session.result import payload_from_profile
    from repro_torch.trace.store import record_from_payloads

    payloads, fit = {}, {}
    try:
        for gb in batches:
            shape = ShapeSpec(f"decode_32k_b{gb}", SEQ, gb, "decode")
            rec, prof = dryrun.run_cell(arch, shape, "single", MACHINE,
                                        return_profile=True, cfg=cfg)
            payloads[f"decode_b{gb}"] = payload_from_profile(prof)
            fit[str(gb)] = {"peak_device_bytes": rec["peak_device_bytes"],
                       "fits_hbm": rec["fits_hbm"]}
    finally:
        release_fake_group()
    return record_from_payloads(
        f"serve/decode_batch/{arch}", payloads, machine=MACHINE,
        meta={"study": "decode_batch", "batches": list(batches),
              "seq": SEQ, "fit": fit})


def study_rows(batches=BATCHES, arch: str = ARCH, store=None,
               cfg=None) -> list[Row]:
    """One row per global batch and the amortization row, every number
    read back from the stored payloads (``store``: a TraceStore; None:
    the workspace's)."""
    from repro_torch.serve.trace import memory_bound_fraction
    from repro_torch.session.workspace import Workspace

    store = store if store is not None else Workspace().trace_store
    record = study_record(batches, arch, cfg)
    store.append(record)
    stored = [r for r in store.records(record.config)
              if r.run_id == record.run_id][-1]

    rows: list[Row] = []
    for gb in batches:
        p = stored.phases[f"decode_b{gb}"]
        bound = max(p["bound_overlap_s"], 1e-12)
        frac = p["compute_s"] / bound
        f = stored.meta["fit"][str(gb)]
        rows.append((
            f"decode_batch/{arch}_b{gb}",
            p["bound_overlap_s"] * 1e6,
            f"frac={frac:.4f};"
            f"tok_s={gb / bound:,.0f};"
            f"mem_frac={memory_bound_fraction(p):.3f};"
            f"peak_gib={f['peak_device_bytes'] / 2**30:.1f};"
            f"fits={f['fits_hbm']}"))
    t0 = batches[0] / max(stored.phases[f"decode_b{batches[0]}"]
                          ["bound_overlap_s"], 1e-12)
    t3 = batches[-1] / max(stored.phases[f"decode_b{batches[-1]}"]
                           ["bound_overlap_s"], 1e-12)
    rows.append((f"decode_batch/{arch}_amortization", 0.0,
                 f"tok_s={t0:,.0f}->{t3:,.0f};"
                 f"gain={t3 / t0:.1f}x;"
                 f"batch_gain={batches[-1] // batches[0]}x"))
    return rows


def main(device: str | torch.device = "cuda", smoke: bool = False
         ) -> list[Row]:
    """``device`` is not read: the study is analytical."""
    return study_rows(SMOKE_BATCHES if smoke else BATCHES)


if __name__ == "__main__":
    import argparse

    from repro_torch.bench.common import emit
    ap = argparse.ArgumentParser(
        description="decode batch-scaling study: bound-limited tok/s vs "
                    "global batch (analytical dry run)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"the batches {SMOKE_BATCHES} instead of "
                         f"{BATCHES}")
    emit(main(smoke=ap.parse_args().smoke))
    sys.exit(0)
