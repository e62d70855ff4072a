"""Reading a ``torch.profiler`` trace of CPU and CUDA activity.

:class:`Trace` keeps the host's operator ranges (name, thread, span,
input shapes and dtypes) and the device's kernels, copies and memsets,
each tied to the operator that launched it by the profiler's link from
the device event to the innermost operator.  From
those it gives the calls of one operator with every device event that
it or an operator inside it launched, the device's busy time inside a
window, the device operations that took the most time, and the longest
idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Op:
    name: str
    tid: int
    start: int          # ns
    end: int
    shapes: list
    dtypes: list
    parent: int = -1    # index into Trace.ops


@dataclasses.dataclass
class DeviceEvent:
    name: str
    kind: str
    start: int          # ns
    end: int
    op: int = -1        # the launching Op's index, -1 when unknown


def _kind(e) -> str:
    """The event's activity: the profiler's own name for it where the
    event has one, else told from its device and name."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        kind = str(at()).split(".")[-1].lower()
        if kind:
            return kind
    name = e.name()
    if str(e.device_type()).split(".")[-1] == "CPU":
        if getattr(e, "is_user_annotation", lambda: False)():
            return "user_annotation"
        if name.startswith(("cuda", "cu")) and "::" not in name:
            return "cuda_runtime"
        return "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


class Trace:
    def __init__(self, events):
        self.ops: list[Op] = []
        self.device: list[DeviceEvent] = []
        by_corr: dict[int, int] = {}
        pending: list[tuple[DeviceEvent, int]] = []
        for e in events:
            kind = _kind(e)
            if kind in HOST_KINDS:
                by_corr[e.correlation_id()] = len(self.ops)
                self.ops.append(Op(e.name(), e.start_thread_id(),
                                   e.start_ns(), e.end_ns(),
                                   list(e.shapes()), list(e.dtypes())))
            elif kind in DEVICE_KINDS:
                ev = DeviceEvent(e.name(), kind, e.start_ns(), e.end_ns())
                self.device.append(ev)
                pending.append((ev, e.linked_correlation_id()))
        # a host annotation's copy on the device timeline is no device work
        marks = {op.name for op in self.ops}
        self.device = [ev for ev in self.device if ev.name not in marks]
        pending = [p for p in pending if p[0].name not in marks]
        self._nest()
        for ev, linked in pending:
            ev.op = by_corr.get(linked, -1)
        self.device.sort(key=lambda d: d.start)

    def _nest(self) -> None:
        """Each op's parent: the innermost op on its thread whose span
        holds it."""
        self._threads: dict[int, list[int]] = defaultdict(list)
        order = sorted(range(len(self.ops)),
                       key=lambda i: (self.ops[i].start, -self.ops[i].end))
        stacks: dict[int, list[int]] = defaultdict(list)
        for i in order:
            op = self.ops[i]
            stack = stacks[op.tid]
            while stack and self.ops[stack[-1]].end < op.end:
                stack.pop()
            op.parent = stack[-1] if stack else -1
            stack.append(i)
            self._threads[op.tid].append(i)
        self._starts = {t: [self.ops[i].start for i in ids]
                        for t, ids in self._threads.items()}

    def _innermost(self, tid: int, t: int) -> int:
        """The innermost op on thread ``tid`` running at time ``t``."""
        ids = self._threads.get(tid)
        if not ids:
            return -1
        k = bisect.bisect_right(self._starts[tid], t) - 1
        # the latest op to start before t, or the innermost of its
        # ancestors that still runs at t (any op running at t that
        # started before it holds it)
        i = ids[k] if k >= 0 else -1
        while i >= 0 and self.ops[i].end < t:
            i = self.ops[i].parent
        return i

    def ancestors(self, i: int):
        while i >= 0:
            yield i
            i = self.ops[i].parent

    def calls(self, name: str) -> list[tuple[Op, list[DeviceEvent]]]:
        """Each call of the op ``name`` (outermost, where calls nest) with
        the device events launched inside it."""
        found: dict[int, list[DeviceEvent]] = {}
        for ev in self.device:
            hit = [i for i in self.ancestors(ev.op)
                   if self.ops[i].name == name]
            if hit:
                found.setdefault(hit[-1], []).append(ev)
        return [(self.ops[i], evs) for i, evs in sorted(found.items())]

    def merged(self, t0: int, t1: int) -> list[tuple[int, int]]:
        """The device's busy intervals inside [t0, t1], merged."""
        out: list[list[int]] = []
        for ev in self.device:
            a, b = max(ev.start, t0), min(ev.end, t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, t0: int, t1: int) -> float:
        return sum(b - a for a, b in self.merged(t0, t1)) * 1e-9

    def device_ops(self, top: int = 10) -> list[list]:
        """[[name, seconds]] of the device operations that took the most
        time in all, by name."""
        total: dict[str, int] = defaultdict(int)
        for ev in self.device:
            total[ev.name] += ev.end - ev.start
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[short(name), ns * 1e-9] for name, ns in ranked]

    def _host_at(self, t: int) -> str | None:
        """What the host was doing at ``t``: the outermost and innermost
        ops running then, on the thread with the deepest stack."""
        best: list[int] = []
        for tid in self._threads:
            i = self._innermost(tid, t)
            chain = list(self.ancestors(i)) if i >= 0 else []
            if len(chain) > len(best):
                best = chain
        if not best:
            return None
        outer, inner = self.ops[best[-1]].name, self.ops[best[0]].name
        return outer if outer == inner else f"{outer} > {inner}"

    def idle_gaps(self, t0: int, t1: int, top: int = 10,
                  marks: list | None = None) -> list[list]:
        """[[what the host was doing, seconds]] of the longest gaps in
        which the device ran nothing, inside [t0, t1]: the phase the host
        was in (``marks``: (start, phase) pairs), the host ops running,
        and the device operation that ended the gap."""
        busy = self.merged(t0, t1)
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [ev.start for ev in self.device]
        out = []
        for a, b in gaps[:top]:
            parts = []
            if marks:
                at = [name for start, name in marks if start <= (a + b) // 2]
                parts.append(at[-1] if at else "before the phases")
            host = self._host_at((a + b) // 2)
            if host:
                parts.append(host)
            k = bisect.bisect_left(starts, b)
            parts.append("then " + short(self.device[k].name)
                         if k < len(starts) else "then the window's end")
            out.append([" | ".join(parts), (b - a) * 1e-9])
        return out


def short(name: str, width: int = 160) -> str:
    """A device operation's name without its namespaces' noise and its
    parameter list."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(noise, "")
    depth = 0
    for i, c in enumerate(name):
        depth += c in "<"
        depth -= c in ">"
        if c == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width].strip()
