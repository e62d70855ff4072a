"""Workspace merge: the union of another workspace's stores into this one
(port of ``repro.obs.merge``).

Hosts that run the same characterization each write a workspace;
``merge_workspace`` folds another root's ``trace.jsonl``, ``sweep.jsonl``
and ``tune.json`` (and its ``bench/BENCH_*.json``) into the local one, so
one root holds the whole fleet's history; report, trend and advise then
group by the machine and host keys every record carries.  Either package
merges a workspace the other wrote.

The identity of an entry, per store:

* trace / sweep (JSONL): ``run_id`` (a uuid stamped at write time); a
  record without one falls back to a content hash;
* tune (JSON): the store key ``kernel|backend|shape|dtype|machine`` — two
  hosts' winners coexist under their machine keys; a same-key conflict
  goes to the newer ``timestamp`` and is reported.  The ``dispatch``
  namespace merges under the same rule;
* bench: the ``BENCH_<utc timestamp>.json`` file name.

The local store is never corrupted: remote corrupt lines, records of a
*newer* schema and same-id conflicts are skipped and counted in the
returned :class:`MergeReport`.  A merge is idempotent — merging the same
remote again adds nothing — and leaves the local header alone when it
adds nothing.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import shutil
import time
from typing import Any


@dataclasses.dataclass
class MergeReport:
    """What one store's merge did (counts and readable notes)."""

    store: str                    # "trace" | "sweep" | "tune" | "bench"
    n_added: int = 0
    n_dup: int = 0                # an identical record already present
    n_conflict: int = 0           # same identity, other content
    n_skipped: int = 0            # corrupt / newer-schema remote records
    notes: list[str] = dataclasses.field(default_factory=list)

    @property
    def merged_any(self) -> bool:
        return self.n_added > 0

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def describe(self) -> str:
        head = (f"{self.store:<6} +{self.n_added} added, {self.n_dup} "
                f"duplicate(s), {self.n_conflict} conflict(s), "
                f"{self.n_skipped} skipped")
        return "\n".join([head] + [f"    {n}" for n in self.notes])


def _record_identity(d: dict[str, Any]) -> str:
    """The run id when stamped, else a content hash (a hand-made record
    without one still dedupes)."""
    rid = d.get("run_id")
    if rid:
        return str(rid)
    blob = json.dumps(d, sort_keys=True).encode()
    return "sha1:" + hashlib.sha1(blob).hexdigest()[:16]


def merge_jsonl(local_path: str, remote_path: str,
                store: str = "trace") -> MergeReport:
    """Union the remote JSONL trace records into the local file by run id:
    only lines that parse, carry a known schema and are absent locally
    are appended, verbatim (their provenance bytes kept)."""
    from repro_torch.trace.store import SCHEMA_VERSION

    rep = MergeReport(store=store)
    if not os.path.exists(remote_path):
        rep.note(f"remote has no {os.path.basename(remote_path)} — nothing "
                 "to merge")
        return rep

    local: dict[str, dict] = {}
    if os.path.exists(local_path):
        with open(local_path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue                 # local corruption is not ours
                if isinstance(d, dict):
                    local[_record_identity(d)] = d

    additions: list[str] = []
    with open(remote_path) as f:
        for i, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                rep.n_skipped += 1
                rep.note(f"{remote_path}:{i}: corrupt line skipped")
                continue
            if not isinstance(d, dict):
                rep.n_skipped += 1
                rep.note(f"{remote_path}:{i}: non-record line skipped")
                continue
            if d.get("schema_version", 0) > SCHEMA_VERSION:
                rep.n_skipped += 1
                rep.note(f"{remote_path}:{i}: schema "
                         f"{d.get('schema_version')} > {SCHEMA_VERSION} "
                         "(newer writer) — skipped")
                continue
            ident = _record_identity(d)
            if ident in local:
                if local[ident] == d:
                    rep.n_dup += 1
                else:
                    rep.n_conflict += 1
                    rep.note(f"{remote_path}:{i}: run {ident} differs from "
                             "the local record — local kept")
                continue
            local[ident] = d
            additions.append(line.rstrip("\n"))

    if additions:
        from repro_torch.resilience.jsonl import repair_jsonl_tail
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        repair_jsonl_tail(local_path)
        with open(local_path, "a") as f:
            for line in additions:
                f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        rep.n_added = len(additions)
    return rep


def merge_tune(local_path: str, remote_path: str) -> MergeReport:
    """Union the remote tune store's winners into the local one by store
    key; a same-key conflict goes to the newer ``timestamp``."""
    from repro_torch.tune.store import SCHEMA_VERSION, _as_store

    rep = MergeReport(store="tune")
    if not os.path.exists(remote_path):
        rep.note("remote has no tune.json — nothing to merge")
        return rep
    try:
        with open(remote_path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError("not a JSON object")
    except (OSError, ValueError) as e:
        rep.n_skipped += 1
        rep.note(f"{remote_path}: corrupt remote tune store skipped ({e})")
        return rep
    if doc.get("schema_version", 0) > SCHEMA_VERSION:
        rep.n_skipped += 1
        rep.note(f"{remote_path}: schema {doc.get('schema_version')} > "
                 f"{SCHEMA_VERSION} (newer writer) — skipped")
        return rep
    remote = doc.get("records")
    remote_dispatch = doc.get("dispatch")
    if not isinstance(remote, dict) and not isinstance(remote_dispatch,
                                                       dict):
        rep.note("remote tune store holds no records")
        return rep

    store = _as_store(local_path)

    def _union(remote_ns: dict, local_ns: dict, what: str) -> dict:
        """Same-key union: identical is a duplicate, different goes to the
        newer timestamp (the one rule both namespaces share)."""
        additions: dict[str, dict] = {}
        for key, d in sorted(remote_ns.items()):
            if not isinstance(d, dict):
                rep.n_skipped += 1
                rep.note(f"{what} key {key!r}: non-record value skipped")
                continue
            if d.get("schema_version", 0) > SCHEMA_VERSION:
                rep.n_skipped += 1
                rep.note(f"{what} key {key!r}: newer-schema record "
                         "skipped")
                continue
            mine = local_ns.get(key)
            if mine is None:
                additions[key] = d
            elif mine == d:
                rep.n_dup += 1
            else:
                rep.n_conflict += 1
                if float(d.get("timestamp", 0)) > float(
                        mine.get("timestamp", 0)):
                    additions[key] = d
                    rep.note(f"{what} key {key!r}: remote winner is "
                             "newer — replaced local")
                else:
                    rep.note(f"{what} key {key!r}: local winner is "
                             "newer — kept")
        return additions

    if isinstance(remote, dict):
        additions = _union(remote, dict(store._load_doc()["records"]),
                           "tune")
        if additions:
            store.put_many(additions)
            rep.n_added += len(additions)
    if isinstance(remote_dispatch, dict):
        additions = _union(remote_dispatch,
                           dict(store._load_doc()["dispatch"]), "dispatch")
        if additions:
            store.put_dispatch_many(additions)
            rep.n_added += len(additions)
    return rep


def merge_bench(local_dir: str, remote_dir: str) -> MergeReport:
    """Copy the remote ``BENCH_*.json`` files absent locally (the file
    name is the identity: one per run and UTC second)."""
    rep = MergeReport(store="bench")
    if not os.path.isdir(remote_dir):
        rep.note("remote has no bench/ dir — nothing to merge")
        return rep
    for src in sorted(glob.glob(os.path.join(remote_dir, "BENCH_*.json"))):
        dst = os.path.join(local_dir, os.path.basename(src))
        if os.path.exists(dst):
            rep.n_dup += 1
            continue
        try:                                # a corrupt harvest is no fault
            with open(src) as f:
                json.load(f)
        except (OSError, ValueError):
            rep.n_skipped += 1
            rep.note(f"{src}: corrupt harvest file skipped")
            continue
        os.makedirs(local_dir, exist_ok=True)
        shutil.copyfile(src, dst)
        rep.n_added += 1
    return rep


def merge_workspace(local: Any, remote_root: str) -> list[MergeReport]:
    """Merge every store of the workspace at ``remote_root`` into the
    local :class:`~repro_torch.session.workspace.Workspace`; one
    :class:`MergeReport` per store.  When anything was added, a
    provenance entry (the remote's root, header identity and counts) is
    appended to the local ``workspace.json``."""
    from repro_torch.session.workspace import Workspace

    remote = Workspace(remote_root)
    if not os.path.isdir(remote.root):
        raise FileNotFoundError(
            f"remote workspace root {remote.root!r} does not exist")
    reports = [
        merge_jsonl(local.trace_path, remote.trace_path, store="trace"),
        merge_jsonl(local.sweep_path, remote.sweep_path, store="sweep"),
        merge_tune(local.tune_path, remote.tune_path),
        merge_bench(local.bench_dir, remote.bench_dir),
    ]
    if any(r.merged_any for r in reports):
        rh = remote.read_header()
        local.record_merge({
            "remote_root": remote.root,
            "remote_machine": rh.get("machine"),
            "remote_host": rh.get("host", {}).get("host"),
            "remote_git_sha": rh.get("git_sha"),
            "added": {r.store: r.n_added for r in reports},
            "conflicts": {r.store: r.n_conflict for r in reports
                          if r.n_conflict},
            "timestamp": time.time(),
        })
    return reports


def render_merge(reports: list[MergeReport], local_root: str,
                 remote_root: str) -> str:
    lines = [f"merge {remote_root} -> {local_root}"]
    lines += ["  " + r.describe().replace("\n", "\n  ") for r in reports]
    total = sum(r.n_added for r in reports)
    lines.append(f"  total: {total} record(s)/file(s) added"
                 + ("" if total else " (no-op)"))
    return "\n".join(lines)
