"""Torn-tail repair for the append-only JSONL stores (port of
``repro.resilience.jsonl``).

A writer that crashes mid-append (power loss, ``os._exit``, an OOM kill)
leaves a partial final line with no trailing newline.  Readers skip it as
corrupt, but the *next* append would run onto the torn bytes and corrupt
a good record too.  :func:`repair_jsonl_tail` runs before every append: it
truncates a torn final line (dropping exactly the one record the crashed
writer lost), or completes a final line that is valid JSON and only lacks
its newline (the crash fell between the payload and the newline: the
record is whole and is kept).
"""

from __future__ import annotations

import json
import os

#: how far back from the end the repair looks for the last newline; one
#: record larger than this is out of contract for these stores
_TAIL_SCAN_BYTES = 4 << 20


def repair_jsonl_tail(path: str) -> int:
    """Repair ``path``'s final line in place.

    Returns the torn bytes truncated (0: the file was clean or missing).
    A newline-terminated file is left untouched; a final fragment that
    parses as JSON gets its newline (0 truncated); anything else after
    the last newline is truncated.
    """
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb+") as f:
        scan = min(size, _TAIL_SCAN_BYTES)
        f.seek(size - scan)
        tail = f.read(scan)
        if tail.endswith(b"\n"):
            return 0
        cut = tail.rfind(b"\n")
        frag = tail[cut + 1:]                     # cut == -1: the whole tail
        try:
            json.loads(frag.decode("utf-8"))
            f.write(b"\n")                        # whole, just unsealed
            f.flush()
            os.fsync(f.fileno())
            return 0
        except (ValueError, UnicodeDecodeError):
            pass
        if cut < 0 and scan < size:
            # no newline in the window: one record larger than the window
            # is out of contract; the reader's corrupt-line skip handles it
            return 0
        f.truncate(size - scan + cut + 1 if cut >= 0 else size - scan)
        f.flush()
        os.fsync(f.fileno())
        return len(frag)


def fsync_append(path: str, line: str) -> None:
    """One durable JSONL append: repair the tail, write, flush, fsync."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    repair_jsonl_tail(path)
    with open(path, "a") as f:
        f.write(line.rstrip("\n") + "\n")
        f.flush()
        os.fsync(f.fileno())
