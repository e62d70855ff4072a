"""Workspace: one root directory for the port's persistent state (port of
the part of ``repro.session.workspace`` that ``record`` / ``report`` and
``tune`` need; the sweep store comes with its subsystem).

.. code-block:: text

    <root>/
    ├── workspace.json           machine-provenance header
    ├── trace.jsonl              measured runs (repro_torch.trace.store)
    └── tune.json                kernel-config and dispatch winners
                                 (repro_torch.tune.store)

Resolution order of the root: an explicit path, then the
``REPRO_WORKSPACE`` environment variable, then ``./.repro-workspace``
inside a checkout (the working directory has ``.git``, or the directory
exists already), else ``~/.repro``.  The file names and the header are
the reference's, so ``repro`` reads a workspace the port wrote.
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
TUNE_FILENAME = "tune.json"
HEADER_FILENAME = "workspace.json"


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
    """The trace and tune stores and their provenance header under one
    root."""

    def __init__(self, root: str | None = None,
                 trace_filename: str = TRACE_FILENAME):
        self.root = os.path.abspath(root or default_workspace_root())
        self.trace_filename = trace_filename
        self._trace_store: TraceStore | None = None
        self._tune_store = None

    @classmethod
    def for_store(cls, path: str) -> "Workspace":
        """The workspace around one trace-store file (``--store``)."""
        path = os.path.abspath(path)
        return cls(os.path.dirname(path), os.path.basename(path))

    def __repr__(self) -> str:
        return f"Workspace({self.root!r})"

    @property
    def trace_path(self) -> str:
        return os.path.join(self.root, self.trace_filename)

    @property
    def tune_path(self) -> str:
        return os.path.join(self.root, TUNE_FILENAME)

    @property
    def header_path(self) -> str:
        return os.path.join(self.root, HEADER_FILENAME)

    @property
    def trace_store(self) -> TraceStore:
        if self._trace_store is None:
            self._trace_store = TraceStore(self.trace_path)
        return self._trace_store

    @property
    def tune_store(self):
        """The :class:`~repro_torch.tune.store.TuneStore` at
        :attr:`tune_path` (shared with the kernel wrappers' lookups)."""
        if self._tune_store is None:
            from repro_torch.tune.store import _as_store
            self._tune_store = _as_store(self.tune_path)
        return self._tune_store

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
        survives rewrites, as do the reference's ``merges`` and ``tags``."""
        os.makedirs(self.root, exist_ok=True)
        prev = self.read_header()
        header = {
            "schema_version": HEADER_SCHEMA_VERSION,
            "machine": machine,
            "git_sha": git_sha(),
            "host": host_fingerprint(),
            "created": prev.get("created", time.time()),
            "updated": time.time(),
            "stores": {"trace": self.trace_filename, "tune": TUNE_FILENAME},
        }
        for key in ("merges", "tags"):
            if prev.get(key):
                header[key] = prev[key]
        tmp = f"{self.header_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(header, f, indent=1, sort_keys=True)
        os.replace(tmp, self.header_path)
        return header
