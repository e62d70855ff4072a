"""Deterministic fault injection (port of ``repro.resilience.faults``):
one plan, hooks at the fragile seams.

A :class:`FaultPlan` is parsed from the ``REPRO_FAULTS`` environment
variable.  In the port one hook queries it so far: the serving engine's
tick (``serve/engine.py``, ``serve_fault``); the reference also threads
it through its sweep engine, trainer, checkpointer and JSONL stores, and
the grammar keeps their kinds so that one plan reads the same in both
packages.  Firing is deterministic: a spec targets one site index (point
ordinal, train step, engine tick, checkpoint step) and fires a bounded
number of times, so the same plan replays the same failure sequence
every run.

Grammar (``;``-separated specs, each ``kind[:target[:arg]][xTIMES]``)::

    crash_point:N[xT]      sweep worker running campaign point ordinal N
                           exits hard (os._exit) — first T attempts
    hang_point:N:SECS[xT]  point N's worker sleeps SECS before compiling
                           (the hung-XLA-compile stand-in the per-point
                           deadline watchdog must kill)
    crash_step:N[xT]       trainer exits hard at global step N (the
                           auto-resume-from-checkpoint scenario)
    step_fault:N[xT]       trainer step N raises TransientFault (the
                           retry-with-backoff scenario)
    ckpt_fail:N[xT]        checkpoint write for step N raises (surfaced
                           promptly by AsyncCheckpointer.healthy())
    torn_tail[:STORE][xT]  the next JSONL append to STORE ("trace",
                           "sweep", ... — basename sans .jsonl; omitted =
                           any store) writes a torn partial line and
                           raises, simulating a crash mid-append
    serve_fault:N[xT]      serve engine tick N raises TransientFault
                           (retried by the engine's tick retry loop)

``xT`` bounds the firings (default 1); ``x-1`` (or ``x*``, spelled
``x-1`` in env vars) never exhausts.  For cross-process sites (sweep
points) the *attempt* number is passed in explicitly so firing does not
depend on per-process counters; for in-process sites (trainer, serve,
checkpoint, stores) a per-plan counter keyed on (kind, target) provides
the same bounded semantics.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
import time
from typing import Any

FAULT_ENV = "REPRO_FAULTS"

#: every kind a plan may contain (parse rejects anything else)
KINDS = ("crash_point", "hang_point", "crash_step", "step_fault",
         "ckpt_fail", "torn_tail", "serve_fault")

#: kinds that take an integer site index as their target
_INT_TARGET = ("crash_point", "hang_point", "crash_step", "step_fault",
               "ckpt_fail", "serve_fault")

#: hard-crash exit code (distinct from any argparse/pytest code so the
#: supervisor and tests can tell an injected crash from a real one)
CRASH_EXIT_CODE = 13

_TIMES_RE = re.compile(r"x(-?\d+)$")


class InjectedFault(RuntimeError):
    """An injected (non-transient) fault fired."""


class TransientFault(InjectedFault):
    """An injected fault the caller is expected to retry past."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault: what fires, where, how hard, how often."""

    kind: str
    target: str | None = None       # site index / store kind; None = any
    arg: float = 0.0                # seconds for hang_point
    times: int = 1                  # firings before going quiet; -1 = always

    @property
    def index(self) -> int | None:
        """Integer view of the target (point ordinal / step / tick)."""
        return int(self.target) if self.target is not None else None

    def render(self) -> str:
        out = self.kind
        if self.target is not None:
            out += f":{self.target}"
        if self.kind == "hang_point":
            out += f":{self.arg:g}"
        if self.times != 1:
            out += f"x{self.times}"
        return out


class FaultPlan:
    """A parsed set of :class:`FaultSpec`\\ s plus per-site fire counters."""

    def __init__(self, specs: list[FaultSpec] | None = None):
        self.specs = list(specs or [])
        self._fired: dict[tuple[str, str | None], int] = {}

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan({self.render()!r})"

    def render(self) -> str:
        return ";".join(s.render() for s in self.specs)

    # -- firing ----------------------------------------------------------
    def fires(self, kind: str, target: Any = None,
              attempt: int | None = None) -> FaultSpec | None:
        """The matching spec if this site visit should fault, else None.

        ``attempt`` (cross-process sites) replaces the internal counter:
        the spec fires iff ``attempt < times``.  Without it, each
        matching call advances a per-(kind, target) counter — bounded
        firing inside one process.
        """
        for spec in self.specs:
            if spec.kind != kind:
                continue
            if (spec.target is not None and target is not None
                    and str(spec.target) != str(target)):
                continue
            if spec.target is not None and target is None:
                continue
            if attempt is not None:
                n = attempt
            else:
                key = (spec.kind, spec.target)
                n = self._fired.get(key, 0)
                self._fired[key] = n + 1
            if spec.times < 0 or n < spec.times:
                return spec
        return None

    # -- hook helpers (one per failure shape) ----------------------------
    def maybe_raise(self, kind: str, target: Any = None,
                    attempt: int | None = None,
                    exc: type = TransientFault) -> None:
        spec = self.fires(kind, target, attempt)
        if spec is not None:
            raise exc(f"injected {spec.render()} at {target}")

    def maybe_crash(self, kind: str, target: Any = None,
                    attempt: int | None = None) -> None:
        """Hard process exit — the no-cleanup crash the watchdog must
        survive.  Flushes stderr so the injection is visible in logs."""
        spec = self.fires(kind, target, attempt)
        if spec is not None:
            print(f"[faults] injected {spec.render()}: hard exit "
                  f"{CRASH_EXIT_CODE} at {target}", file=sys.stderr,
                  flush=True)
            os._exit(CRASH_EXIT_CODE)

    def maybe_hang(self, kind: str, target: Any = None,
                   attempt: int | None = None) -> float:
        """Sleep the spec's seconds (the hung-compile stand-in); returns
        the seconds slept (0.0 = no fault)."""
        spec = self.fires(kind, target, attempt)
        if spec is None:
            return 0.0
        print(f"[faults] injected {spec.render()}: hanging {spec.arg:g}s "
              f"at {target}", file=sys.stderr, flush=True)
        time.sleep(spec.arg)
        return spec.arg


def parse_plan(text: str | None) -> FaultPlan:
    """Parse a ``REPRO_FAULTS`` string; raises ValueError on bad specs."""
    specs: list[FaultSpec] = []
    for part in (text or "").split(";"):
        part = part.strip()
        if not part:
            continue
        times = 1
        m = _TIMES_RE.search(part)
        if m:
            times = int(m.group(1))
            part = part[:m.start()]
        fields = part.split(":")
        kind = fields[0]
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; known: {', '.join(KINDS)}")
        target: str | None = None
        arg = 0.0
        if kind in _INT_TARGET:
            if len(fields) < 2:
                raise ValueError(f"{kind} needs a target index "
                                 f"({kind}:N), got {part!r}")
            try:
                target = str(int(fields[1]))
            except ValueError:
                raise ValueError(f"{kind} target must be an integer, "
                                 f"got {fields[1]!r}") from None
        elif len(fields) > 1 and fields[1]:
            target = fields[1]
        if kind == "hang_point":
            if len(fields) < 3:
                raise ValueError("hang_point needs seconds "
                                 "(hang_point:N:SECS), got " + repr(part))
            arg = float(fields[2])
        elif len(fields) > (2 if kind in _INT_TARGET else 2):
            raise ValueError(f"too many fields in {part!r}")
        if times == 0 or times < -1:
            raise ValueError(f"xTIMES must be >= 1 or -1 (always), "
                             f"got {times} in {part!r}")
        specs.append(FaultSpec(kind=kind, target=target, arg=arg,
                               times=times))
    return FaultPlan(specs)


_active: tuple[str, FaultPlan] | None = None


def active_plan() -> FaultPlan:
    """The process-wide plan from ``REPRO_FAULTS`` (cached per value, so
    counters persist while the variable is unchanged; an unparsable value
    raises — a typo'd chaos run must not silently run fault-free)."""
    global _active
    text = os.environ.get(FAULT_ENV, "")
    if _active is None or _active[0] != text:
        _active = (text, parse_plan(text))
    return _active[1]
