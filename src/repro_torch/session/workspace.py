"""Workspace: one root directory for the port's persistent state (port of
``repro.session.workspace``).

.. code-block:: text

    <root>/
    ├── workspace.json           machine-provenance header, run tags,
    │                            merge provenance
    ├── trace.jsonl              measured runs (repro_torch.trace.store)
    ├── sweep.jsonl              campaign points (the same store class)
    ├── sweep_journal.jsonl      campaign lifecycle journal
    │                            (repro_torch.resilience.journal)
    ├── sweep_cache/             per-point analysis cache (repro_torch.sweep)
    ├── tune.json                kernel-config and dispatch winners
    │                            (repro_torch.tune.store)
    └── bench/                   BENCH_<ts>.json of python -m repro_torch.bench

Resolution order of the root: an explicit path, then the
``REPRO_WORKSPACE`` environment variable, then ``./.repro-workspace``
inside a checkout (the working directory has ``.git``, or the directory
exists already), else ``~/.repro``.  The file names and the header (schema
version 1, with its ``tags`` and ``merges``) are the reference's, so
either package reads, resumes and merges a workspace the other wrote.
The port has no per-store legacy defaults (``benchmarks/results/``): it
never wrote there.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from repro_torch.trace.store import TraceStore, git_sha, host_fingerprint

WORKSPACE_ENV = "REPRO_WORKSPACE"
HEADER_SCHEMA_VERSION = 1
TRACE_FILENAME = "trace.jsonl"
SWEEP_FILENAME = "sweep.jsonl"
JOURNAL_FILENAME = "sweep_journal.jsonl"
SWEEP_CACHE_DIRNAME = "sweep_cache"
TUNE_FILENAME = "tune.json"
HEADER_FILENAME = "workspace.json"
BENCH_DIRNAME = "bench"


def default_workspace_root() -> str:
    """``REPRO_WORKSPACE``, else ``./.repro-workspace`` in a checkout, else
    ``~/.repro``."""
    env = os.environ.get(WORKSPACE_ENV)
    if env:
        return env
    local = os.path.join(os.getcwd(), ".repro-workspace")
    if os.path.isdir(local) or os.path.isdir(os.path.join(os.getcwd(),
                                                          ".git")):
        return local
    return os.path.join(os.path.expanduser("~"), ".repro")


class Workspace:
    """The trace, sweep and tune stores, the journal, the analysis cache
    and the bench harvests under one root, bound by one provenance
    header."""

    def __init__(self, root: str | None = None,
                 trace_filename: str = TRACE_FILENAME):
        self.root = os.path.abspath(root or default_workspace_root())
        self.trace_filename = trace_filename
        self._trace_store: TraceStore | None = None
        self._sweep_store: TraceStore | None = None
        self._tune_store = None

    @classmethod
    def for_store(cls, path: str) -> "Workspace":
        """The workspace around one trace-store file (``--store``)."""
        path = os.path.abspath(path)
        return cls(os.path.dirname(path), os.path.basename(path))

    def __repr__(self) -> str:
        return f"Workspace({self.root!r})"

    # -- layout ----------------------------------------------------------
    @property
    def trace_path(self) -> str:
        return os.path.join(self.root, self.trace_filename)

    @property
    def sweep_path(self) -> str:
        return os.path.join(self.root, SWEEP_FILENAME)

    @property
    def journal_path(self) -> str:
        return os.path.join(self.root, JOURNAL_FILENAME)

    @property
    def sweep_cache_dir(self) -> str:
        return os.path.join(self.root, SWEEP_CACHE_DIRNAME)

    @property
    def tune_path(self) -> str:
        return os.path.join(self.root, TUNE_FILENAME)

    @property
    def header_path(self) -> str:
        return os.path.join(self.root, HEADER_FILENAME)

    @property
    def bench_dir(self) -> str:
        return os.path.join(self.root, BENCH_DIRNAME)

    def store_paths(self) -> dict[str, str]:
        return {"trace": self.trace_path, "sweep": self.sweep_path,
                "tune": self.tune_path}

    # -- stores ----------------------------------------------------------
    @property
    def trace_store(self) -> TraceStore:
        if self._trace_store is None:
            self._trace_store = TraceStore(self.trace_path)
        return self._trace_store

    @property
    def sweep_store(self) -> TraceStore:
        """Sweep records share the trace schema: a separate file, the
        same class."""
        if self._sweep_store is None:
            self._sweep_store = TraceStore(self.sweep_path)
        return self._sweep_store

    @property
    def tune_store(self):
        """The :class:`~repro_torch.tune.store.TuneStore` at
        :attr:`tune_path` (shared with the kernel wrappers' lookups)."""
        if self._tune_store is None:
            from repro_torch.tune.store import _as_store
            self._tune_store = _as_store(self.tune_path)
        return self._tune_store

    # -- provenance header -----------------------------------------------
    def ensure(self) -> "Workspace":
        os.makedirs(self.root, exist_ok=True)
        return self

    def read_header(self) -> dict[str, Any]:
        """The stored header, or ``{}`` (a corrupt header is never
        fatal)."""
        try:
            with open(self.header_path) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def write_header(self, machine: str) -> dict[str, Any]:
        """Stamp (or refresh) the machine-provenance header; ``created``
        survives rewrites, as do ``merges`` and ``tags``."""
        self.ensure()
        prev = self.read_header()
        header = {
            "schema_version": HEADER_SCHEMA_VERSION,
            "machine": machine,
            "git_sha": git_sha(),
            "host": host_fingerprint(),
            "created": prev.get("created", time.time()),
            "updated": time.time(),
            "stores": {k: os.path.basename(v)
                       for k, v in self.store_paths().items()},
        }
        for key in ("merges", "tags"):
            if prev.get(key):
                header[key] = prev[key]
        self._write_header_doc(header)
        return header

    def _write_header_doc(self, header: dict[str, Any]) -> None:
        tmp = f"{self.header_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(header, f, indent=1, sort_keys=True)
        os.replace(tmp, self.header_path)

    def _header_or_new(self) -> dict[str, Any]:
        self.ensure()
        return self.read_header() or {
            "schema_version": HEADER_SCHEMA_VERSION, "created": time.time()}

    def record_merge(self, entry: dict[str, Any]) -> dict[str, Any]:
        """Append one merge's provenance (the remote's identity and the
        records added per store) to the header's ``merges`` list."""
        header = self._header_or_new()
        header.setdefault("merges", []).append(dict(entry))
        header["updated"] = time.time()
        self._write_header_doc(header)
        return header

    def tag_run(self, name: str, run_id: str) -> dict[str, Any]:
        """Pin a run id under a name in the header's ``tags`` (``trend tag
        NAME``), so that the trend gate can anchor to a known-good run
        instead of the rolling median."""
        header = self._header_or_new()
        header.setdefault("tags", {})[str(name)] = {
            "run_id": str(run_id), "created": time.time()}
        header["updated"] = time.time()
        self._write_header_doc(header)
        return header

    def tags(self) -> dict[str, dict[str, Any]]:
        """The header's run tags (``{}`` when none were set)."""
        tags = self.read_header().get("tags")
        return dict(tags) if isinstance(tags, dict) else {}

    def resolve_tag(self, name_or_run: str) -> str:
        """A tag → its pinned run id; anything else passes through (so
        ``--baseline`` takes either)."""
        entry = self.tags().get(str(name_or_run))
        if isinstance(entry, dict) and entry.get("run_id"):
            return str(entry["run_id"])
        return str(name_or_run)

    def describe(self) -> str:
        header = self.read_header()
        lines = [f"workspace: {self.root}"]
        if header:
            lines.append(
                f"  header: machine={header.get('machine', '?')} "
                f"git={str(header.get('git_sha', '?'))[:12]} "
                f"host={header.get('host', {}).get('host', '?')}")
        for kind, path in self.store_paths().items():
            mark = "present" if os.path.exists(path) else "absent"
            lines.append(f"  {kind:<6} {os.path.basename(path):<12} {mark}")
        return "\n".join(lines)
