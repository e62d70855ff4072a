"""Cross-config aggregation: stored sweep records → ranked table and
roofline gallery (port of ``repro.sweep.aggregate``).

The report side reads the store only: it renders everything from the
JSONL records a campaign persisted (nothing runs again), so a sweep made
on the card can be ranked and charted anywhere, and the reference's
records read the same.  Two artifacts:

* :func:`summary_rows` → ``repro_torch.core.report.sweep_table``: one row
  per sweep point, achieved against bound with the time fraction of each
  memory level, best %-of-roofline first;
* :func:`gallery`: one hierarchical ASCII roofline per point (paper Figs
  3-9; on Hopper the levels are ``l2`` and ``hbm``) with the measured
  achieved points overlaid, rebuilt from the records' stored top-kernel
  payloads.

Besides, the tune provenance: which kernel configs and dispatch winners a
measured point ran with against what the tune store holds now
(:func:`tune_mismatch_rows`).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from repro_torch.core.machine import MACHINES, get_machine
from repro_torch.core.op_analysis import KernelRecord
from repro_torch.core.report import ascii_roofline, sweep_table
from repro_torch.trace.store import TraceRecord, TraceStore

_AMP_CLASS = {"O0": "f32", "O1": "bf16", "O2": "bf16"}


def _machine_of(rec: TraceRecord):
    """The record's machine model (``cpu-host`` for a name the port does
    not know, as the reference falls back)."""
    return get_machine(rec.machine if rec.machine in MACHINES
                       else "cpu-host")


def _records(records) -> list[TraceRecord]:
    return list(records.values() if isinstance(records, Mapping)
                else records)


def sweep_records(store: TraceStore, name: str | None = None
                  ) -> list[TraceRecord]:
    """Every record a sweep wrote (``meta.sweep_point`` present), of one
    campaign when ``name`` is given, oldest first."""
    def pred(rec: TraceRecord) -> bool:
        if "sweep_point" not in rec.meta:
            return False
        return name is None or rec.meta.get("sweep") == name
    return store.records_where(pred)


def latest_per_point(records: Sequence[TraceRecord]
                     ) -> dict[str, TraceRecord]:
    """Newest record per sweep-point key (a re-run supersedes; the history
    stays in the store)."""
    out: dict[str, TraceRecord] = {}
    for rec in records:                      # oldest → newest
        out[rec.meta["sweep_point"]] = rec
    return out


def _label(rec: TraceRecord) -> str:
    # stamped by the engine (SweepPoint.label); a hand-made record with a
    # sparse meta falls back to its config
    return str(rec.meta.get("label") or rec.config)


def summary_row(rec: TraceRecord) -> dict[str, Any]:
    """Fold one record's phases into one achieved-vs-bound row."""
    machine = _machine_of(rec)
    wall = sum(float(p.get("wall_s", 0.0)) for p in rec.phases.values())
    bound_ov = sum(float(p.get("bound_overlap_s", 0.0))
                   for p in rec.phases.values())
    flops = sum(float(p.get("flops", 0.0)) for p in rec.phases.values())
    hbm = sum(float(p.get("hbm_bytes", 0.0)) for p in rec.phases.values())
    vmem = sum(float(p.get("vmem_bytes", 0.0)) for p in rec.phases.values())
    # each level's streaming time as a fraction of the measured wall (the
    # hierarchical view); vmem_bytes is the on-chip level's traffic
    hbm_s = hbm / machine.hbm.bytes_per_s
    vmem_s = vmem / machine.vmem.bytes_per_s
    terms = {"compute": 0.0, "memory": 0.0, "collective": 0.0}
    for p in rec.phases.values():
        terms["compute"] += float(p.get("compute_s", 0.0))
        terms["memory"] += float(p.get("memory_s", 0.0))
        terms["collective"] += float(p.get("collective_s", 0.0))
    measured = wall > 0
    return {
        "key": rec.meta.get("sweep_point", rec.run_id),
        "config": rec.config,
        "label": _label(rec),
        # the fusion mode the point ran at: a "static" row is the
        # before/after counterpart of the same config's "off" row
        "fusion": str(rec.meta.get("fusion", "off")),
        "measured": measured,
        "machine": rec.machine,
        "wall_s": wall,
        "bound_overlap_s": bound_ov,
        "achieved_flops_per_s": flops / wall if measured else 0.0,
        "pct_of_roofline": bound_ov / wall if measured else 0.0,
        "hbm_frac": hbm_s / wall if measured else 0.0,
        "vmem_frac": vmem_s / wall if measured else 0.0,
        "dominant": max(terms, key=terms.get),
        "run_id": rec.run_id,
    }


def summary_rows(records: Mapping[str, TraceRecord] | Sequence[TraceRecord]
                 ) -> list[dict[str, Any]]:
    return [summary_row(r) for r in _records(records)]


def render_summary(records: Mapping[str, TraceRecord] | Sequence[TraceRecord]
                   ) -> str:
    return sweep_table(summary_rows(records))


def kernel_config_lines(records: Mapping[str, TraceRecord]
                        | Sequence[TraceRecord]) -> list[str]:
    """One line per measured point naming the kernel configs it ran with
    (its ``meta.kernel_configs`` stamp)."""
    out: list[str] = []
    for rec in _records(records):
        kcfg = rec.meta.get("kernel_configs")
        if not isinstance(kcfg, dict) or not kcfg:
            continue
        parts = []
        for kernel, info in sorted(kcfg.items()):
            if not isinstance(info, dict):
                continue
            src = info.get("source", "?")
            if src == "tuned_available":
                n = len(info.get("entries", ()))
                parts.append(f"{kernel}=tuned_available({n} shape(s))")
            else:
                params = ",".join(f"{k}={v}" for k, v in
                                  sorted(info.get("params", {}).items()))
                parts.append(f"{kernel}={src}({params})")
        if parts:
            out.append(f"  cfg {_label(rec)}: " + " ".join(parts))
    return out


def tune_mismatch_rows(records: Mapping[str, TraceRecord]
                       | Sequence[TraceRecord], tune_store=None,
                       machine: str | None = None) -> list[dict[str, Any]]:
    """Measured points whose tune provenance no longer matches the store
    under ``machine``'s key (``None``: each record's own machine; the
    reference reads ``cpu-host`` then, and so flags every point measured
    under another key).

    A record's ``meta.kernel_configs`` says what the store offered when it
    ran: ``default`` (no winner for that kernel) or ``tuned_available``.
    A point measured under ``default`` while the store now holds a winner
    (``stale_default``), or the reverse (``vanished_tuned``), is stale
    evidence.  Likewise ``meta.dispatch_table``: a site whose winner has
    changed (``dispatch_changed``) or left the store
    (``dispatch_vanished``; ``kernel`` then names the site's op).  One row
    per mismatch: ``{label, run_id, kernel, kind[, site]}``.
    """
    from repro_torch.tune.store import _as_store, tuned_kernels
    tuned_by: dict[str, set] = {}
    now_dispatch = _as_store(tune_store).dispatch_records()
    rows: list[dict[str, Any]] = []
    for rec in _records(records):
        key = machine or rec.machine
        if key not in tuned_by:
            tuned_by[key] = set(tuned_kernels(tune_store, machine=key))
        now_tuned = tuned_by[key]
        kcfg = rec.meta.get("kernel_configs")
        if isinstance(kcfg, dict):
            for kernel, info in sorted(kcfg.items()):
                source = (info.get("source") if isinstance(info, dict)
                          else None)
                if source == "default" and kernel in now_tuned:
                    rows.append({"label": _label(rec),
                                 "run_id": rec.run_id, "kernel": kernel,
                                 "kind": "stale_default"})
                elif source == "tuned_available" and kernel not in now_tuned:
                    rows.append({"label": _label(rec),
                                 "run_id": rec.run_id, "kernel": kernel,
                                 "kind": "vanished_tuned"})
        dtab = rec.meta.get("dispatch_table")
        if isinstance(dtab, dict):
            for site, entry in sorted(dtab.items()):
                if not isinstance(entry, dict):
                    continue
                op = str(entry.get("op", site))
                now = now_dispatch.get(site)
                if now is None:
                    rows.append({"label": _label(rec),
                                 "run_id": rec.run_id, "kernel": op,
                                 "kind": "dispatch_vanished",
                                 "site": site})
                elif now.get("impl") != entry.get("impl"):
                    rows.append({"label": _label(rec),
                                 "run_id": rec.run_id, "kernel": op,
                                 "kind": "dispatch_changed",
                                 "site": site})
    return rows


def tune_mismatches(records: Mapping[str, TraceRecord] | Sequence[TraceRecord],
                    tune_store=None) -> list[str]:
    """:func:`tune_mismatch_rows` as the sweep report's flag lines (empty:
    all consistent)."""
    flags: list[str] = []
    for row in tune_mismatch_rows(records, tune_store):
        if row["kind"] == "stale_default":
            flags.append(
                f"{row['label']}: measured with default {row['kernel']} "
                "config, but a tuned winner now exists — re-run "
                "(`python -m repro_torch sweep run`) to pick it up")
        elif row["kind"] == "vanished_tuned":
            flags.append(
                f"{row['label']}: measured while tuned {row['kernel']} "
                "config(s) were available, but the tune store no "
                "longer has them — wall times are not reproducible "
                "from current state")
        elif row["kind"] == "dispatch_changed":
            flags.append(
                f"{row['label']}: dispatch winner for {row['kernel']} "
                "site changed since this point was measured — re-run to "
                "route through the current winner")
        else:
            flags.append(
                f"{row['label']}: dispatch entry for {row['kernel']} "
                "site vanished from the tune store — routing is no "
                "longer reproducible from current state")
    return flags


# --------------------------------------------------------------------------
# Gallery: roofline charts rebuilt from the stored kernel payloads
# --------------------------------------------------------------------------

def kernels_from_record(rec: TraceRecord) -> list[KernelRecord]:
    """Chartable :class:`KernelRecord`\\ s from a record's stored
    top-kernel payloads.  The payload keeps *totals* (FLOPs × exec
    count), so each comes back with ``exec_count=1`` and all its FLOPs in
    the AMP policy's class (the per-class split is not stored; the chart
    needs only each kernel's AI and ceiling)."""
    cls = _AMP_CLASS.get(str(rec.meta.get("amp", "O1")), "bf16")
    out: list[KernelRecord] = []
    for p in rec.phases.values():
        for k in p.get("kernels", ()):
            flops = float(k.get("flops", 0.0))
            hbm = int(k.get("hbm_bytes", 0))
            vmem = int(k.get("vmem_bytes", 0)) or hbm
            out.append(KernelRecord(
                name=str(k.get("name", "?")), opcode="fusion", op_name="",
                exec_count=1,
                flops_by_class={cls: flops} if flops else {},
                hbm_bytes=hbm, vmem_bytes=vmem,
                category=str(k.get("category", "?"))))
    return out


def achieved_from_record(rec: TraceRecord) -> list[tuple[float, float]]:
    """(AI at HBM, achieved FLOP/s) overlay points of the stored
    kernels."""
    pts = []
    for p in rec.phases.values():
        for k in p.get("kernels", ()):
            ai = float(k.get("ai_hbm", 0.0))
            ach = float(k.get("achieved_flops_per_s", 0.0))
            if ai > 0 and ach > 0:
                pts.append((ai, ach))
    return pts


def gallery(records: Mapping[str, TraceRecord] | Sequence[TraceRecord],
            max_charts: int = 12) -> str:
    """One hierarchical roofline per point, the measured achieved points
    overlaid."""
    recs = _records(records)
    charts = [ascii_roofline(kernels_from_record(rec), _machine_of(rec),
                             title=_label(rec),
                             achieved=achieved_from_record(rec) or None)
              for rec in recs[:max_charts]]
    if len(recs) > max_charts:
        charts.append(f"... {len(recs) - max_charts} more point(s) — "
                      "rerun with a higher --charts limit")
    return "\n\n".join(charts)
