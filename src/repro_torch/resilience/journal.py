"""Crash-safe campaign journal: which sweep points survived what (port of
``repro.resilience.journal``).

One ``sweep_journal.jsonl`` sits beside the sweep store.  The engine
appends one fsync'd line per lifecycle event:

* ``attempt``    — a point was dispatched (point key, label, attempt);
* ``done``       — its record landed in the store (run id);
* ``fail``       — the attempt errored, crashed or timed out (reason);
* ``quarantine`` — the point used up its attempts.

``sweep run --resume`` replays the journal and skips every point with a
``done`` event.  A point is named by its :attr:`SweepPoint.key` content
hash, so an edited point is never skipped.  The lines are the
reference's byte for byte: either package resumes a campaign the other
journalled.  The journal follows the stores' rules: a torn tail is
repaired before an append, corrupt lines are skipped on read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

from repro_torch.resilience.jsonl import fsync_append, repair_jsonl_tail

#: lifecycle events a journal line may carry
EVENTS = ("attempt", "done", "fail", "quarantine")


@dataclasses.dataclass
class JournalState:
    """Replay of one campaign's journal (the newest event wins per
    point)."""

    done: dict[str, str] = dataclasses.field(default_factory=dict)
    #: point key -> attempts logged (across every journalled invocation)
    attempts: dict[str, int] = dataclasses.field(default_factory=dict)
    quarantined: dict[str, str] = dataclasses.field(default_factory=dict)
    failures: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def n_done(self) -> int:
        return len(self.done)


class CampaignJournal:
    """Append-only journal of sweep-point lifecycle events."""

    def __init__(self, path: str):
        self.path = path

    def log(self, event: str, *, sweep: str, point: str, label: str = "",
            attempt: int = 0, run_id: str | None = None,
            reason: str | None = None, **extra: Any) -> dict[str, Any]:
        """Append one event line durably (flush + fsync: a crash after
        ``log`` returns cannot lose the event)."""
        if event not in EVENTS:
            raise ValueError(f"unknown journal event {event!r}; "
                             f"known: {EVENTS}")
        entry: dict[str, Any] = {
            "ts": time.time(), "event": event, "sweep": sweep,
            "point": point, "label": label, "attempt": attempt,
        }
        if run_id is not None:
            entry["run_id"] = run_id
        if reason is not None:
            entry["reason"] = reason
        entry.update(extra)
        fsync_append(self.path, json.dumps(entry))
        return entry

    def entries(self, sweep: str | None = None) -> list[dict[str, Any]]:
        """Every readable event, oldest first (corrupt lines skipped)."""
        repair_jsonl_tail(self.path)
        out: list[dict[str, Any]] = []
        try:
            f = open(self.path)
        except OSError:
            return out
        with f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(d, dict):
                    continue
                if sweep is None or d.get("sweep") == sweep:
                    out.append(d)
        return out

    def replay(self, sweep: str) -> JournalState:
        """Fold one campaign's events into a :class:`JournalState`.  A
        later ``done`` clears an earlier ``quarantine`` (a resumed run
        landed the point); the engine never dispatches a done point
        again, so the reverse cannot happen."""
        state = JournalState()
        for e in self.entries(sweep):
            key = str(e.get("point", ""))
            if not key:
                continue
            event = e.get("event")
            if event == "attempt":
                state.attempts[key] = state.attempts.get(key, 0) + 1
            elif event == "done":
                state.done[key] = str(e.get("run_id", ""))
                state.quarantined.pop(key, None)
                state.failures.pop(key, None)
            elif event == "fail":
                state.failures[key] = str(e.get("reason", ""))
            elif event == "quarantine":
                state.quarantined[key] = str(e.get("reason", ""))
        return state

    def summary(self, sweep: str) -> dict[str, Any]:
        """The campaign's health as JSON: done count, quarantined and
        still-failing points with their reasons and attempts."""
        state = self.replay(sweep)
        return {
            "sweep": sweep,
            "done": len(state.done),
            "quarantined": [
                {"point": k, "reason": v,
                 "attempts": state.attempts.get(k, 0)}
                for k, v in sorted(state.quarantined.items())],
            "failed": [
                {"point": k, "reason": v,
                 "attempts": state.attempts.get(k, 0)}
                for k, v in sorted(state.failures.items())
                if k not in state.done and k not in state.quarantined],
        }


def journal_path_for(store_path: str) -> str:
    """The journal beside the sweep store it covers, so a ``--store`` or
    ``REPRO_WORKSPACE`` move keeps the pair together."""
    return os.path.join(os.path.dirname(os.path.abspath(store_path)),
                        "sweep_journal.jsonl")
