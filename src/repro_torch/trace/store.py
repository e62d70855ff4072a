"""Append-only JSONL results store for measured trace runs (port of
``repro.trace.store``).

One line per run, schema-versioned (``schema_version``), in the
reference's schema: ``repro.trace.store.TraceStore`` reads the port's
records and ``repro.trace.compare`` diffs them unchanged.  Run metadata
binds every record to its provenance: git SHA, host fingerprint (torch,
CUDA and the card in place of the reference's jax keys), machine model
and config name.  The on-chip level's bytes travel under ``vmem_bytes``,
as in the reference's payloads.

The store is plain JSONL, append-only: corrupt lines are skipped on read,
records from a newer schema are skipped with a warning, and an append is
durable (flush + fsync) and repairs a torn final line left by a crashed
writer before its record lands (``repro_torch.resilience.jsonl``).  A
``torn_tail[:STORE]`` fault (``REPRO_FAULTS``) makes the next append to
the store write half its line and raise, as a crash mid-append would.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import sys
import time
import uuid
import warnings
from typing import Any, Iterable, Mapping

from repro_torch.resilience import faults
from repro_torch.resilience.jsonl import (fsync_append,
                                          repair_jsonl_tail)
from repro_torch.trace.collector import PhaseMeasurement

SCHEMA_VERSION = 1

# phase-payload metric keys every record carries (compare iterates these)
PHASE_METRICS = ("wall_s", "achieved_flops_per_s", "pct_of_roofline",
                 "bound_overlap_s", "bound_serial_s")


def git_sha(repo_root: str | None = None) -> str:
    """HEAD commit of the repo containing this file (or ``repo_root``)."""
    root = repo_root or os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def host_fingerprint() -> dict[str, str]:
    """Where the measurement ran: the host, torch, its CUDA and the card
    (``"none"`` without one)."""
    import torch
    cuda = torch.cuda.is_available()
    return {
        "host": platform.node(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device": torch.cuda.get_device_name(0) if cuda else "none",
        "backend": "cuda" if cuda else "cpu",
    }


@dataclasses.dataclass
class TraceRecord:
    """One measured run of one config: the unit of storage and comparison."""

    schema_version: int
    run_id: str
    timestamp: float                 # unix seconds
    git_sha: str
    config: str
    machine: str                     # MachineSpec.name the %s are against
    mesh: dict[str, int]             # axis name -> size ({} = single device)
    host: dict[str, str]
    phases: dict[str, dict[str, Any]]   # phase name -> metric payload
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        # no sort_keys: phase insertion order is the step order (fwd→bwd→opt)
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TraceRecord":
        """Tolerant constructor: unknown keys dropped, missing keys
        defaulted."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw.setdefault("schema_version", 0)
        kw.setdefault("run_id", "")
        kw.setdefault("timestamp", 0.0)
        kw.setdefault("git_sha", "unknown")
        kw.setdefault("config", "")
        kw.setdefault("machine", "")
        kw.setdefault("mesh", {})
        kw.setdefault("host", {})
        kw.setdefault("phases", {})
        return cls(**kw)


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


def record_from_payloads(config: str,
                         phases: Mapping[str, Mapping[str, Any]],
                         machine: str,
                         mesh: Mapping[str, int] | None = None,
                         meta: Mapping[str, Any] | None = None) -> TraceRecord:
    """TraceRecord from already-serialized phase payloads, stamped with
    its provenance."""
    return TraceRecord(
        schema_version=SCHEMA_VERSION,
        run_id=uuid.uuid4().hex[:12],
        timestamp=time.time(),
        git_sha=git_sha(),
        config=config,
        machine=machine,
        mesh=dict(mesh or {}),
        host=host_fingerprint(),
        phases={name: dict(p) for name, p in phases.items()},
        meta=dict(meta or {}))


def record_from_phases(config: str,
                       measurements: Mapping[str, PhaseMeasurement],
                       machine: str,
                       mesh: Mapping[str, int] | None = None,
                       meta: Mapping[str, Any] | None = None,
                       top_kernels: int = 8) -> TraceRecord:
    return record_from_payloads(
        config,
        {name: phase_payload(m, top_kernels)
         for name, m in measurements.items()},
        machine=machine, mesh=mesh, meta=meta)


class TraceStore:
    """Append-only JSONL store of :class:`TraceRecord` lines."""

    def __init__(self, path: str):
        self.path = path

    @property
    def _store_kind(self) -> str:
        """The store name fault specs target (``torn_tail:sweep``): the
        file's basename without ``.jsonl``."""
        base = os.path.basename(self.path)
        return base[:-len(".jsonl")] if base.endswith(".jsonl") else base

    def append(self, rec: TraceRecord) -> TraceRecord:
        line = rec.to_json()
        spec = faults.active_plan().fires("torn_tail", self._store_kind)
        if spec is None:
            fsync_append(self.path, line)
            return rec
        # a writer crash mid-append: half the line durably on disk, no
        # newline, then the fault
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        repair_jsonl_tail(self.path)
        with open(self.path, "a") as f:
            f.write(line[:max(1, len(line) // 2)])
            f.flush()
            os.fsync(f.fileno())
        raise faults.InjectedFault(
            f"injected {spec.render()}: torn append to {self.path}")

    def records(self, config: str | None = None) -> list[TraceRecord]:
        """All readable records, oldest first; corrupt lines and
        newer-schema records are skipped (with a warning), never fatal."""
        if not os.path.exists(self.path):
            return []
        out: list[TraceRecord] = []
        with open(self.path) as f:
            for i, line in enumerate(f):
                if not line.strip():
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    warnings.warn(f"{self.path}:{i+1}: corrupt line skipped")
                    continue
                if d.get("schema_version", 0) > SCHEMA_VERSION:
                    warnings.warn(
                        f"{self.path}:{i+1}: schema "
                        f"{d.get('schema_version')} > {SCHEMA_VERSION} "
                        "(written by newer code) — skipped")
                    continue
                rec = TraceRecord.from_dict(d)
                if config is None or rec.config == config:
                    out.append(rec)
        return out

    def last(self, config: str | None = None, n: int = 1
             ) -> list[TraceRecord]:
        """Last ``n`` records (oldest→newest among those returned)."""
        recs = self.records(config)
        return recs[-n:] if n else []

    def run(self, run_id: str) -> TraceRecord | None:
        for rec in self.records():
            if rec.run_id == run_id or rec.run_id.startswith(run_id):
                return rec
        return None

    def configs(self) -> list[str]:
        seen: dict[str, None] = {}
        for rec in self.records():
            seen.setdefault(rec.config)
        return list(seen)

    def records_where(self, predicate) -> list[TraceRecord]:
        """Readable records matching ``predicate(rec)``, oldest first
        (``lambda r: r.meta.get("sweep") == name``)."""
        return [rec for rec in self.records() if predicate(rec)]


def iter_jsonl(path: str) -> Iterable[dict]:
    """Raw dict view of a store file (debugging / ad-hoc analysis)."""
    with open(path) as f:
        for line in f:
            if line.strip():
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue
