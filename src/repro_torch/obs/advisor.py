"""Bottleneck advisor: mine stored trace records for known performance
patterns and rank evidence-cited remediations (port of
``repro.obs.advisor``).

Every rule reads only persisted state (trace and sweep records, the tune
store): nothing is walked or timed again, so ``advise`` runs wherever the
workspace is.

==================  =====================================================
rule                pattern → remediation
==================  =====================================================
launch_overhead     measured wall past the serial bound with a high
                    zero-AI launch share (paper Table III census, stored
                    per phase) → ``--fusion static`` / ``auto``
                    (``repro_torch.kernels.fused``)
scatter_heavy       scatter launches in a backward phase → the fused
                    routes' scatter-free embedding backward
tune_mismatch       a record measured under kernel configs or dispatch
                    winners that differ from the tune store's now
                    (stale_default / vanished_tuned / dispatch_changed /
                    dispatch_vanished) → measure again / ``tune search``
                    / ``tune dispatch search``
untuned             every kernel at its default while the tune store holds
                    no winner for the machine → ``tune search``
dispatch_stale      a record whose ``meta.dispatch_table`` winners were
                    measured under another git SHA or torch version than
                    the record itself → ``tune dispatch search --force``
level_pinned        one memory level's streaming time is most of the
                    measured wall → the phase sits under that level's
                    bandwidth roof; raise arithmetic intensity
network_bound       a record's summed collective bound exceeds both its
                    memory and compute bounds → the interconnect roof;
                    fires only on records that store collective bounds
                    (a single-card record stores none)
decode_bandwidth_   a ``serve/<config>`` series whose decode phase's
regress             achieved HBM-bandwidth fraction *drops* as the slot
                    count grows → batching loses bandwidth efficiency
==================  =====================================================

Findings are ranked by severity (a rule-specific score) and each cites
its evidence: run ids, phases, and the stored numbers the rule matched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

#: the rules, in the order of the table above
RULES = ("launch_overhead", "scatter_heavy", "tune_mismatch", "untuned",
         "level_pinned", "dispatch_stale", "network_bound",
         "decode_bandwidth_regress")

#: zero-AI launch share past which launch overhead is called dominant
ZERO_AI_SHARE = 0.15

#: share of the measured wall one level's streaming time must reach
LEVEL_PIN_FRAC = 0.5

#: relative drop of the decode bandwidth fraction (against the smaller
#: batch) that counts as a regression rather than noise
DECODE_BW_DROP = 0.05


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnosed pattern: what, where, the numbers, and the fix."""

    rule: str
    severity: float               # ranking score; higher: act sooner
    subject: str                  # "config/phase" or "config"
    evidence: list[str]           # the stored numbers the rule matched
    remediation: str

    def describe(self) -> str:
        lines = [f"[{self.rule}] {self.subject} "
                 f"(severity {self.severity:.2f})"]
        lines += [f"    evidence: {e}" for e in self.evidence]
        lines.append(f"    fix: {self.remediation}")
        return "\n".join(lines)


def _host(rec: Any) -> str:
    return rec.host.get("host", "?") if isinstance(rec.host, dict) else "?"


def _machine(name: str):
    from repro_torch.core.machine import MACHINES, get_machine
    return get_machine(name if name in MACHINES else "cpu-host")


def _newest_per_key(records: Iterable[Any]) -> list[Any]:
    """Newest record per (config, machine, host, fusion): the advisor
    diagnoses the current state, not the history."""
    out: dict[tuple, Any] = {}
    for rec in sorted(records, key=lambda r: r.timestamp):
        out[(rec.config, rec.machine, _host(rec),
             str(rec.meta.get("fusion", "off")))] = rec
    return list(out.values())


def _phase_launches(p: dict[str, Any]) -> tuple[int, int, int]:
    """(launches, zero-AI, scatter) of one stored phase payload: the
    census totals where the record carries them, else (an undercount,
    which the caller notes) its stored top kernels."""
    if "launches" in p:
        return (int(p.get("launches", 0)),
                int(p.get("zero_ai_launches", 0)),
                int(p.get("scatter_launches", 0)))
    kernels = p.get("kernels", ())
    launches = sum(int(k.get("exec_count", 0)) for k in kernels)
    zero = sum(int(k.get("exec_count", 0)) for k in kernels
               if not float(k.get("flops", 0.0)))
    scatter = sum(int(k.get("exec_count", 0)) for k in kernels
                  if "scatter" in str(k.get("name", "")).lower())
    return launches, zero, scatter


def _level_bytes_key(machine, level) -> str:
    """The payload key of a level's bytes: the on-chip level's travel
    under ``vmem_bytes`` whatever its name (``l2`` on Hopper)."""
    if level is machine.hbm:
        return "hbm_bytes"
    if level is machine.vmem:
        return "vmem_bytes"
    return f"{level.name}_bytes"


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

def rule_launch_overhead(records: Iterable[Any]) -> list[Finding]:
    from repro_torch.trace.timeline import timeline_from_record

    out: list[Finding] = []
    for rec in records:
        if str(rec.meta.get("fusion", "off")) != "off":
            continue                  # the remediation is applied already
        for span in timeline_from_record(rec).spans:
            if span.verdict not in ("serial", "overhead"):
                continue
            p = rec.phases.get(span.name, {})
            launches, zero, _ = _phase_launches(p)
            if not launches:
                continue
            share = zero / launches
            if share < ZERO_AI_SHARE:
                continue
            exact = "launches" in p
            over = (span.measured_s / span.bound_serial_s
                    if span.bound_serial_s else float("inf"))
            out.append(Finding(
                rule="launch_overhead",
                severity=min(over, 10.0) * share,
                subject=f"{rec.config}/{span.name}",
                evidence=[
                    f"run {rec.run_id}: {span.name} measured "
                    f"{span.measured_s * 1e3:.3f}ms vs serial bound "
                    f"{span.bound_serial_s * 1e3:.3f}ms "
                    f"({over:.2f}x, verdict {span.verdict})",
                    f"zero-AI launch share {share:.0%} "
                    f"({zero}/{launches} launches"
                    + ("" if exact else ", top-kernel estimate") + ")",
                ],
                remediation="re-record with the hand-written kernels "
                            "(`python -m repro_torch record --fusion "
                            "static`, or `--fusion auto` after a dispatch "
                            "search): repro_torch.kernels.fused folds the "
                            "zero-AI chains this census counts"))
    return out


def rule_scatter_heavy(records: Iterable[Any]) -> list[Finding]:
    out: list[Finding] = []
    for rec in records:
        if str(rec.meta.get("fusion", "off")) != "off":
            continue
        for phase, p in rec.phases.items():
            launches, _, scatter = _phase_launches(p)
            if not scatter or phase == "fwd":
                continue              # backward / optimizer scatter only
            out.append(Finding(
                rule="scatter_heavy",
                severity=min(1.0, scatter / max(launches, 1) * 5),
                subject=f"{rec.config}/{phase}",
                evidence=[
                    f"run {rec.run_id}: {scatter} scatter launch(es) of "
                    f"{launches} in {phase}",
                ],
                remediation="set fusion=static — the scatter-free "
                            "embedding backward (kernels.fused.ops."
                            "embed_with_onehot_grad) replaces the scatter "
                            "with one matmul where it is eligible"))
    return out


def rule_tune_mismatch(records: Iterable[Any], tune_store=None,
                       machine: str = "cpu-host") -> list[Finding]:
    from repro_torch.sweep.aggregate import tune_mismatch_rows

    kinds = {
        "stale_default": (
            0.6,
            "default {k} config, but the tune store now holds a tuned "
            "winner",
            "measure again (`python -m repro_torch record` / `python -m "
            "repro_torch sweep run`) so the wall times reflect the "
            "store's current best configs"),
        "vanished_tuned": (
            0.8,
            "tuned {k} config(s) that the tune store no longer has",
            "run `python -m repro_torch tune search` again to restore the "
            "winners this record was measured under"),
        "dispatch_changed": (
            0.6,
            "a {k} dispatch winner the store has since overturned",
            "measure again so the routing reflects the current dispatch "
            "winners (`python -m repro_torch record --fusion auto`)"),
        "dispatch_vanished": (
            0.8,
            "a {k} dispatch entry the tune store no longer holds",
            "run `python -m repro_torch tune dispatch search` again to "
            "restore the routing this record was measured under"),
    }
    out: list[Finding] = []
    for row in tune_mismatch_rows(list(records), tune_store,
                                  machine=machine):
        severity, what, fix = kinds[row["kind"]]
        out.append(Finding(
            rule="tune_mismatch",
            severity=severity,
            subject=f"{row['label']}/{row['kernel']}",
            evidence=[
                f"run {row['run_id']}: measured with "
                + what.format(k=row["kernel"]),
            ],
            remediation=fix))
    return out


def rule_untuned(records: Iterable[Any], tune_store=None,
                 machine: str = "cpu-host") -> list[Finding]:
    from repro_torch.tune.store import tuned_kernels

    if tuned_kernels(tune_store, machine=machine):
        return []
    out: list[Finding] = []
    for rec in records:
        kcfg = rec.meta.get("kernel_configs")
        if not isinstance(kcfg, dict) or not kcfg:
            continue
        defaults = sorted(k for k, info in kcfg.items()
                          if isinstance(info, dict)
                          and info.get("source") == "default")
        if len(defaults) < len(kcfg):
            continue
        out.append(Finding(
            rule="untuned",
            severity=0.3,
            subject=rec.config,
            evidence=[
                f"run {rec.run_id}: every kernel at its default config "
                f"({', '.join(defaults)}) and the tune store has no "
                f"winners for machine {machine}",
            ],
            remediation="run `python -m repro_torch tune search` — the "
                        "winners persist per machine key, and the kernel "
                        "wrappers launch with them"))
        break                         # one finding, not one per record
    return out


def rule_dispatch_stale(records: Iterable[Any]) -> list[Finding]:
    """Dispatch winners measured under other code or another toolchain
    than the record that ran with them: each stamped
    ``meta.dispatch_table`` entry carries the git SHA and the ``torch``
    version its fused-against-plain timing ran under; when they differ
    from the record's own (``git_sha``, ``host["torch"]``), the routing
    predates the code that made the wall times."""
    out: list[Finding] = []
    for rec in records:
        dtab = rec.meta.get("dispatch_table")
        if not isinstance(dtab, dict) or not dtab:
            continue
        rec_sha = str(rec.git_sha or "unknown")
        rec_torch = (rec.host.get("torch", "unknown")
                     if isinstance(rec.host, dict) else "unknown")
        stale: list[str] = []
        for site, entry in sorted(dtab.items()):
            if not isinstance(entry, dict):
                continue
            e_sha = str(entry.get("git_sha", "unknown"))
            e_torch = str(entry.get("torch", "unknown"))
            drift = []
            if "unknown" not in (e_sha, rec_sha) and e_sha != rec_sha:
                drift.append(f"git {e_sha[:12]} vs {rec_sha[:12]}")
            if "unknown" not in (e_torch, rec_torch) \
                    and e_torch != rec_torch:
                drift.append(f"torch {e_torch} vs {rec_torch}")
            if drift:
                stale.append(f"{entry.get('op', site)} "
                             f"({', '.join(drift)})")
        if not stale:
            continue
        out.append(Finding(
            rule="dispatch_stale",
            severity=min(1.0, 0.4 + 0.1 * len(stale)),
            subject=rec.config,
            evidence=[
                f"run {rec.run_id}: {len(stale)} dispatch winner(s) "
                "measured under different provenance than the record: "
                + "; ".join(stale[:4])
                + ("" if len(stale) <= 4 else f"; +{len(stale) - 4} more"),
            ],
            remediation="measure the dispatch table again on this code "
                        "(`python -m repro_torch tune dispatch search "
                        "--force`) before trusting the routing these walls "
                        "ran with"))
    return out


def rule_level_pinned(records: Iterable[Any]) -> list[Finding]:
    out: list[Finding] = []
    for rec in records:
        machine = _machine(rec.machine)
        for phase, p in rec.phases.items():
            wall = float(p.get("wall_s", 0.0))
            if wall <= 0:
                continue
            for lv in machine.mem_levels:
                nbytes = float(p.get(_level_bytes_key(machine, lv), 0.0))
                if not lv.bytes_per_s or not nbytes:
                    continue
                frac = (nbytes / lv.bytes_per_s) / wall
                if frac < LEVEL_PIN_FRAC:
                    continue
                out.append(Finding(
                    rule="level_pinned",
                    severity=min(frac, 1.0),
                    subject=f"{rec.config}/{phase}",
                    evidence=[
                        f"run {rec.run_id}: {lv.name} streaming bound "
                        f"{nbytes / lv.bytes_per_s * 1e3:.3f}ms is "
                        f"{frac:.0%} of the {wall * 1e3:.3f}ms measured "
                        f"wall (dominant={p.get('dominant', '?')})",
                    ],
                    remediation=f"{phase} is pinned under the {lv.name} "
                                "bandwidth roof — raise arithmetic "
                                "intensity (larger batch/seq, AMP "
                                "O1/O2) or fuse the streaming chain "
                                "(fusion=static)"))
    return out


def rule_network_bound(records: Iterable[Any]) -> list[Finding]:
    """Points whose collective bound exceeds both the memory and the
    compute bounds: the interconnect roof binds.  Reads the stored
    ``ici_bound_s`` / ``dcn_bound_s``; a single-card record stores none,
    so the rule fires only on records that carry collective bounds."""
    # newest per point including the mesh: each shape is its own regime
    newest: dict[tuple, Any] = {}
    for rec in sorted(records, key=lambda r: r.timestamp):
        newest[(rec.config, rec.machine, _host(rec),
                tuple(sorted((rec.mesh or {}).items())))] = rec
    out: list[Finding] = []
    for rec in newest.values():
        compute = memory = ici = dcn = 0.0
        for p in rec.phases.values():
            compute += float(p.get("compute_s", 0.0))
            memory += float(p.get("memory_s", 0.0))
            ici += float(p.get("ici_bound_s", 0.0))
            dcn += float(p.get("dcn_bound_s", 0.0))
        net = ici + dcn
        if net <= 0 or net <= max(compute, memory):
            continue
        mesh = "x".join(str(v) for _, v in sorted((rec.mesh or {}).items())) \
            or "1x1"
        evidence = [
            f"run {rec.run_id}: collective bound {net * 1e3:.3f}ms "
            f"(ici {ici * 1e3:.3f}ms + dcn {dcn * 1e3:.3f}ms) exceeds "
            f"memory {memory * 1e3:.3f}ms and compute "
            f"{compute * 1e3:.3f}ms at mesh {mesh}",
            "bounds use datasheet interconnect ceilings (the port measures "
            "no collective roofs yet: its network level is ROADMAP.md "
            "queue 1 item 8)",
        ]
        out.append(Finding(
            rule="network_bound",
            severity=net / (net + max(compute, memory)),
            subject=f"{rec.config}@{mesh}",
            evidence=evidence,
            remediation="the point sits under the interconnect roof: cut "
                        "the bytes on the wire (a compressed gradient "
                        "all-reduce), grow the work per device (a bigger "
                        "per-device batch, a smaller model axis), or stop "
                        "scaling this config past the flip point"))
    return out


def rule_decode_bandwidth_regress(records: Iterable[Any]) -> list[Finding]:
    """``serve/<config>`` series whose decode phase's achieved
    HBM-bandwidth fraction *drops* as the batch (slot count) grows.
    Decode is bandwidth-bound: more slots amortize the weight stream, so
    the fraction should rise or hold.  A drop past
    :data:`DECODE_BW_DROP` means batching loses efficiency.  Newest
    record per (config, machine, host, fusion, slots), compared along the
    slot axis."""
    by_series: dict[tuple, dict[int, Any]] = {}
    for rec in sorted(records, key=lambda r: r.timestamp):
        if not str(rec.config).startswith("serve/"):
            continue
        p = rec.phases.get("decode")
        if not isinstance(p, dict) or float(p.get("wall_s", 0.0)) <= 0:
            continue
        slots = rec.meta.get("n_slots")
        if not isinstance(slots, int) or slots <= 0:
            continue
        key = (rec.config, rec.machine, _host(rec),
               str(rec.meta.get("fusion", "off")))
        by_series.setdefault(key, {})[slots] = rec

    out: list[Finding] = []
    for key, by_slots in by_series.items():
        if len(by_slots) < 2:
            continue
        machine = _machine(key[1])
        fracs: list[tuple[int, float, Any]] = []
        for slots, rec in sorted(by_slots.items()):
            p = rec.phases["decode"]
            wall = float(p.get("wall_s", 0.0))
            frac = (float(p.get("hbm_bytes", 0.0)) / wall
                    / machine.hbm.bytes_per_s)
            fracs.append((slots, frac, rec))
        worst: tuple[float, Any, Any] | None = None
        for (s0, f0, r0), (s1, f1, r1) in zip(fracs, fracs[1:]):
            if f0 <= 0:
                continue
            drop = 1.0 - f1 / f0
            if drop > DECODE_BW_DROP and (worst is None
                                          or drop > worst[0]):
                worst = (drop, (s0, f0, r0), (s1, f1, r1))
        if worst is None:
            continue
        drop, (s0, f0, r0), (s1, f1, r1) = worst
        out.append(Finding(
            rule="decode_bandwidth_regress",
            severity=min(1.0, drop * 2),
            subject=f"{key[0]}/decode",
            evidence=[
                f"run {r1.run_id}: decode achieved-HBM-bandwidth fraction "
                f"{f1:.1%} at {s1} slot(s) vs {f0:.1%} at {s0} slot(s) "
                f"(run {r0.run_id}) — a {drop:.0%} drop where batching "
                "should amortize weight streaming",
            ],
            remediation="decode efficiency fell as the batch grew: check "
                        "the continuous-batching scheduler (slot "
                        "fragmentation, prefill starving decode ticks) "
                        "and the KV-cache page layout; record `python -m "
                        "repro_torch serve --slots N` at both batch sizes "
                        "to bisect"))
    return out


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def advise(workspace: Any, config: str | None = None,
           machine: str = "cpu-host") -> list[Finding]:
    """Every rule over the workspace's stores; the findings ranked."""
    trace_recs = workspace.trace_store.records(config)
    sweep_recs = workspace.sweep_store.records(config)
    newest = _newest_per_key(trace_recs)
    stamped = [r for r in trace_recs + sweep_recs
               if isinstance(r.meta.get("kernel_configs"), dict)
               or isinstance(r.meta.get("dispatch_table"), dict)]
    tune_store = workspace.tune_store
    findings = (rule_launch_overhead(newest)
                + rule_scatter_heavy(newest)
                + rule_tune_mismatch(stamped, tune_store, machine=machine)
                + rule_untuned(stamped, tune_store, machine=machine)
                + rule_level_pinned(newest)
                + rule_dispatch_stale(stamped)
                # sweep points too: analytical mesh sweeps carry the
                # collective bounds that flag a network-bound regime
                + rule_network_bound(trace_recs + sweep_recs)
                + rule_decode_bandwidth_regress(trace_recs))
    findings.sort(key=lambda f: (-f.severity, f.rule, f.subject))
    return findings


def render_findings(findings: list[Finding], top: int = 0) -> str:
    if not findings:
        return ("advise: no known bottleneck patterns in the stored "
                "records (or no measured records yet)")
    shown = findings[:top] if top else findings
    lines = [f"advise: {len(findings)} finding(s), ranked:"]
    for i, f in enumerate(shown, 1):
        lines.append(f"{i}. " + f.describe())
    if len(findings) > len(shown):
        lines.append(f"... {len(findings) - len(shown)} more (raise --top)")
    return "\n".join(lines)
