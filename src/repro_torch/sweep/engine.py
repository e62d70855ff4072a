"""Campaign execution: expand → supervised workers → sweep store (port of
``repro.sweep.engine``).

Every point runs the analytical pipeline — the aten-op walk of its fwd,
bwd and opt phases on **meta** tensors, which allocates nothing and needs
no card, so every registry config runs at its full size — and, when
``measured``, the same phases built on ``device`` and timed there
(``repro_torch.core.profiler``), the measured wall folded in
(``repro_torch.trace.collector``).  One trace-schema
:class:`~repro_torch.trace.store.TraceRecord` per point lands in the
sweep store, stamped with the sweep's name and the point's content hash;
the report side groups on those.

* **Spawned, pinned workers.**  Points run in a
  :class:`~repro_torch.resilience.watchdog.SupervisedPool` of spawned
  processes (a forked child of a process that has initialized CUDA
  cannot use the card), one pool per device-count group.  Each worker's
  initializer pins ``CUDA_VISIBLE_DEVICES`` to its group's card or cards
  before its first CUDA call (a group that measures nothing sees no
  card), then makes its CUDA context.
* **Per-point analysis cache.**  An analytical point is a function of the
  point, its config, the machine model and torch's version: its phase
  payloads are cached under the point key, so running a campaign again
  walks only the points whose definition changed.  A measured point
  always runs: a wall-clock sample is not cacheable.

Resilience: a point past ``deadline_s`` has its worker killed and
replaced; a failed point is retried with exponential backoff and
quarantined after ``retries + 1`` attempts; every lifecycle event lands
fsync'd in the campaign journal (``sweep_journal.jsonl`` beside the
store), so ``resume`` skips every point whose record already landed,
across any number of crashes.  The journal and the store are the
reference's format: either package resumes the other's campaign.

The reference folds measured interconnect ceilings into the machine
model and stamps ``meta.net_ceilings``; the port has no network level
yet (``ROADMAP.md`` queue 1 item 8), so both wait for it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Mapping

from repro_torch.resilience import faults
from repro_torch.resilience.journal import CampaignJournal, journal_path_for
from repro_torch.resilience.watchdog import SupervisedPool
from repro_torch.session.workspace import (SWEEP_CACHE_DIRNAME,
                                           TUNE_FILENAME, Workspace)
from repro_torch.sweep.spec import SweepPoint, SweepSpec


@dataclasses.dataclass
class PointResult:
    """Outcome of one point: a stored record's id, or a failure."""

    point: SweepPoint
    run_id: str | None = None
    error: str | None = None
    cached: bool = False
    wall_s: float = 0.0             # total measured step time (0: analytical)
    attempts: int = 1
    quarantined: bool = False       # used up its attempts in this campaign
    resumed: bool = False           # skipped: its record landed before

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class SweepResult:
    results: list[PointResult]
    skipped: list[tuple[SweepPoint, str]]

    @property
    def n_ok(self) -> int:
        return sum(1 for r in self.results if r.ok)

    @property
    def n_failed(self) -> int:
        return sum(1 for r in self.results if not r.ok)

    @property
    def n_cached(self) -> int:
        return sum(1 for r in self.results if r.cached)

    @property
    def n_quarantined(self) -> int:
        return sum(1 for r in self.results if r.quarantined)

    @property
    def n_resumed(self) -> int:
        return sum(1 for r in self.results if r.resumed)

    def failure_summary(self) -> list[str]:
        """One line per failed point: label, attempts, the error's last
        line (the whole traceback stays in the journal's reason)."""
        out = []
        for r in self.results:
            if r.ok:
                continue
            lines = [ln for ln in (r.error or "").splitlines() if ln.strip()]
            last = lines[-1].strip() if lines else "unknown error"
            tag = "quarantined" if r.quarantined else "failed"
            out.append(f"{r.point.label}: {tag} after {r.attempts} "
                       f"attempt(s) — {last}")
        return out


# --------------------------------------------------------------------------
# One point, in this process
# --------------------------------------------------------------------------

def _build_point(point: SweepPoint, device):
    """({phase: (fn, args)}, run) of one point: its ``RunConfig`` carries
    only ``amp`` and ``fusion``, as the reference's (attention runs
    ``einsum``, the SSD ``xla``); the tensors lie on ``device``
    (``meta`` for an analytical point)."""
    from repro_torch.session.session import TRAIN_PHASES, build_phases

    if point.n_devices > 1:
        raise NotImplementedError(
            f"{point.label}: mesh {point.mesh[0]}x{point.mesh[1]} needs "
            f"{point.n_devices} devices, and the port shards nothing yet: "
            "its port of distributed/sharding.py is ROADMAP.md queue 1 "
            "item 8")
    return build_phases(point.config, phases=TRAIN_PHASES, seq=point.seq,
                        batch=point.batch, amp=point.amp,
                        fusion=point.fusion, attn_impl="einsum",
                        ssd_impl="xla", smoke=point.smoke, n_layers=None,
                        device=device)


def _matmul_class(run) -> str | None:
    """AMP policy → the ceiling class assumed for products and convs."""
    import torch
    return "bf16" if run.compute_dtype == torch.bfloat16 else None


def _resolve_machine(name: str):
    """The machine model a point's bounds are against: the registry spec
    (the reference folds measured interconnect ceilings in; they wait for
    the port's network level)."""
    from repro_torch.core.machine import get_machine
    return get_machine(name)


def _analytical_payload(res, machine) -> dict[str, Any]:
    """Phase payload of a bound-only point: a zero-wall measurement, so
    the schema is exactly ``trace.store.phase_payload``'s — the measured
    fields come out zero, the bounds are the record's substance."""
    from repro_torch.trace.collector import measurement_from_profile
    from repro_torch.trace.store import phase_payload
    res.wall_s = 0.0
    m = measurement_from_profile(res, machine)
    # zero wall attributes zero time everywhere: rank by bound instead,
    # so the stored top kernels are the analytically hottest
    m.kernels.sort(key=lambda k: -k.bound_s)
    return phase_payload(m)


def _cache_path(cache_dir: str, point: SweepPoint) -> str:
    import torch

    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.core.machine import MACHINES
    # an analytical payload is a function of the point, the resolved
    # config, the machine model and the torch build (a new lowering moves
    # the walk): hash all of them, so an edited config or MachineSpec
    # misses instead of serving stale bounds
    cfg = get_smoke(point.config) if point.smoke else get_config(point.config)
    machine = (_resolve_machine(point.machine)
               if point.machine in MACHINES else None)
    env = json.dumps({
        "config": dataclasses.asdict(cfg),
        "machine": dataclasses.asdict(machine) if machine else point.machine,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }, sort_keys=True, default=str)
    tag = f"{point.key}-{hashlib.sha256(env.encode()).hexdigest()[:16]}"
    return os.path.join(cache_dir, f"{tag}.json")


def _cache_load(cache_dir: str | None,
                point: SweepPoint) -> dict[str, Any] | None:
    if not cache_dir:
        return None
    path = _cache_path(cache_dir, point)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _cache_save(cache_dir: str | None, point: SweepPoint,
                phases: Mapping[str, Any]) -> None:
    if not cache_dir:
        return
    os.makedirs(cache_dir, exist_ok=True)
    path = _cache_path(cache_dir, point)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(dict(phases), f)
    os.replace(tmp, path)


def run_point(point: SweepPoint, *, iters: int = 3, warmup: int = 1,
              cache_dir: str | None = None, sweep_name: str | None = None,
              device: str = "cuda", tune_store: str | None = None):
    """Run one sweep point in this process → ``(TraceRecord, cached)``.

    An analytical point walks its phases on meta tensors (nothing at all
    on a cache hit); a measured point builds them on ``device`` (the
    card unless the caller asks for the CPU; never a fallback) and times
    them, its ``meta`` naming the device and, as ``Session.record``
    stamps them, the ``kernel_configs`` and ``dispatch_table`` that the
    tune store ``tune_store`` (a path; ``None``: the default
    workspace's) held under the point's machine key.
    """
    import torch

    from repro_torch.core.profiler import profile_fn
    from repro_torch.trace.store import (record_from_payloads,
                                         record_from_phases)
    from repro_torch.tune.dispatch import dispatch_scope

    mesh_dict = {"data": point.mesh[0], "model": point.mesh[1]}
    meta = {"sweep_point": point.key, "sweep": sweep_name or "adhoc",
            "label": point.label, **point.to_dict()}
    machine = _resolve_machine(point.machine)

    if not point.measured:
        cached = _cache_load(cache_dir, point)
        if cached is not None:
            return record_from_payloads(
                point.config, cached, machine=point.machine, mesh=mesh_dict,
                meta={**meta, "cached": True}), True
        with dispatch_scope(store=tune_store, machine=point.machine):
            phases, run = _build_point(point, torch.device("meta"))
            payloads = {
                name: _analytical_payload(profile_fn(
                    fn, args=args, name=name, machine=machine,
                    matmul_class=_matmul_class(run)), machine)
                for name, (fn, args) in phases.items()}
        _cache_save(cache_dir, point, payloads)
        return record_from_payloads(
            point.config, payloads, machine=point.machine, mesh=mesh_dict,
            meta={**meta, "cached": False}), False

    from repro_torch.device import device_label, resolve_device
    from repro_torch.trace.collector import measurement_from_profile
    from repro_torch.tune.dispatch import active_dispatch_table
    from repro_torch.tune.store import active_kernel_configs

    dev = resolve_device(device)
    meta["device"] = device_label(dev)
    # which kernel configs and dispatch winners this measurement runs
    # with: the report side flags points measured with defaults after a
    # tuned winner appeared
    meta["kernel_configs"] = active_kernel_configs(machine=point.machine,
                                                   store=tune_store)
    meta["dispatch_table"] = active_dispatch_table(machine=point.machine,
                                                   store=tune_store)
    with dispatch_scope(store=tune_store, machine=point.machine, device=dev):
        phases, run = _build_point(point, dev)
        ms = {}
        for name, (fn, args) in phases.items():
            res = profile_fn(fn, args=args, name=name, machine=machine,
                             measure=True, measure_iters=iters,
                             measure_warmup=warmup,
                             matmul_class=_matmul_class(run))
            ms[name] = measurement_from_profile(res, machine)
            del res                  # the opt phase's output holds a state
    del phases
    if dev.type == "cuda":
        torch.cuda.empty_cache()     # the next point starts from a clean pool
    return record_from_phases(point.config, ms, machine=point.machine,
                              mesh=mesh_dict, meta=meta), False


# --------------------------------------------------------------------------
# Worker pool (one pool per device-count group)
# --------------------------------------------------------------------------

def _worker_init(cards: str) -> None:
    """Runs in the spawned worker before its first task: pins
    ``CUDA_VISIBLE_DEVICES`` to ``cards`` (``""``: none) before any CUDA
    call of this process, then makes the CUDA context of a worker that
    sees a card, so a point's deadline does not pay for it."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("CUDA was initialized before the worker pinned "
                           "its cards")
    os.environ["CUDA_VISIBLE_DEVICES"] = cards
    if cards:
        import torch
        torch.empty(1, device="cuda")


def _group_cards(device, n_devices: int) -> str:
    """The cards a group's workers see: ``n_devices`` from the measuring
    device's index on, none for a group that measures nothing on a
    card."""
    if device is None or device.type != "cuda":
        return ""
    first = device.index or 0
    return ",".join(str(first + i) for i in range(n_devices))


def _point_job(point_dict: dict, iters: int, warmup: int,
               cache_dir: str | None, sweep_name: str | None,
               index: int = 0, attempt: int = 0, in_worker: bool = False,
               device: str = "cuda", tune_store: str | None = None) -> dict:
    """Worker entry: run one point, return a picklable outcome.

    ``index`` is the point's ordinal in the campaign and ``attempt`` its
    retry count — the fault sites' identity (``crash_point:INDEX``,
    ``hang_point:INDEX:SECS``), passed in because counters do not cross
    the process boundary.  Inline (``in_worker=False``) neither fires: an
    inline hang cannot be killed, an inline ``os._exit`` would take the
    campaign with it.
    """
    point = SweepPoint.from_dict(point_dict)
    if in_worker:
        plan = faults.active_plan()
        plan.maybe_crash("crash_point", target=index, attempt=attempt)
        plan.maybe_hang("hang_point", target=index, attempt=attempt)
    try:
        rec, cached = run_point(point, iters=iters, warmup=warmup,
                                cache_dir=cache_dir, sweep_name=sweep_name,
                                device=device, tune_store=tune_store)
    except Exception:
        return {"point": point_dict, "error": traceback.format_exc()}
    return {"point": point_dict, "record": json.loads(rec.to_json()),
            "cached": cached}


def _append_outcome(store, point: SweepPoint, outcome: dict) -> PointResult:
    from repro_torch.trace.store import TraceRecord
    if outcome.get("error"):
        return PointResult(point, error=outcome["error"])
    rec = TraceRecord.from_dict(outcome["record"])
    store.append(rec)
    wall = sum(float(p.get("wall_s", 0.0)) for p in rec.phases.values())
    return PointResult(point, run_id=rec.run_id,
                       cached=bool(outcome.get("cached")), wall_s=wall)


def _resume_run_ids(store, journal: CampaignJournal | None,
                    sweep_name: str) -> dict[str, str]:
    """Point key → run id of every point that landed in an earlier run of
    this campaign: the journal's ``done`` events and a scan of the store
    (which covers a crash between the store's append and the journal's
    ``done`` line: the store is the truth)."""
    done: dict[str, str] = {}
    if journal is not None:
        done.update(journal.replay(sweep_name).done)
    try:
        for rec in store.records_where(
                lambda r: r.meta.get("sweep") == sweep_name):
            key = rec.meta.get("sweep_point")
            if key:
                done[str(key)] = rec.run_id
    except OSError:
        pass
    return done


def run_sweep(sweep: SweepSpec, *, store_path: str | None = None,
              workers: int | None = None,
              cache_dir: "str | None | type(Ellipsis)" = ...,
              progress: Callable[[str], None] | None = None,
              deadline_s: float | None = None,
              retries: int = 1,
              backoff_s: float = 0.25,
              resume: bool = False,
              journal_path: "str | None | type(Ellipsis)" = ...,
              device: str = "cuda",
              tune_store: str | None = None) -> SweepResult:
    """Run a whole campaign: expand, run, store one record per point.

    ``store_path=None`` is the default workspace's ``sweep.jsonl``; the
    store's directory is the campaign's workspace: the analysis cache
    (``cache_dir``; ``None`` means no cache, so the default is ``...``),
    the journal (``journal_path``; ``None`` disables it, and with it the
    journal's half of ``resume``) and the tune store the measured points
    stamp and launch with (``tune_store``) default to the files there.

    ``device``: where measured points run (the card unless the caller
    asks for the CPU; an analytical point runs on meta tensors whatever
    it says).  ``workers``: pool size; ``0`` runs every point inline in
    this process (single-device points).  ``None`` is
    ``min(4, cpu_count)`` for an analytical sweep and ``1`` for a
    measured one: concurrent measurements share the device and skew each
    other.

    ``deadline_s`` kills (and replaces) a worker whose point runs longer
    — a worker's first point loads the kernel libraries, so keep it
    above that; ``retries`` bounds the extra attempts of a point (the
    backoff doubles from ``backoff_s`` each round) before it is
    **quarantined**; ``resume=True`` skips the points whose record landed
    already (journal ∪ store, keyed by the point's content hash: no
    duplicates).
    """
    from repro_torch.trace.store import TraceStore

    store_path = store_path or Workspace().sweep_path
    here = os.path.dirname(os.path.abspath(store_path))
    if cache_dir is ...:
        cache_dir = os.path.join(here, SWEEP_CACHE_DIRNAME)
    if journal_path is ...:
        journal_path = journal_path_for(store_path)
    if tune_store is None:
        tune_store = os.path.join(here, TUNE_FILENAME)
    dev = None
    if sweep.measure:
        from repro_torch.device import resolve_device
        dev = resolve_device(device)          # raises without the card
    journal = CampaignJournal(journal_path) if journal_path else None
    say = progress or (lambda s: None)
    points, skipped = sweep.expand()
    for p, reason in skipped:
        say(f"[skip] {p.label}: {reason}")
    store = TraceStore(store_path)
    results: list[PointResult] = []

    if workers is None:
        workers = 1 if sweep.measure else min(4, os.cpu_count() or 1)

    done_ids = (_resume_run_ids(store, journal, sweep.name)
                if resume else {})
    todo: list[tuple[int, SweepPoint]] = []
    for i, point in enumerate(points):
        run_id = done_ids.get(point.key)
        if run_id is not None:
            res = PointResult(point, run_id=run_id or None, resumed=True,
                              attempts=0)
            results.append(res)
            say(_ok_line(res))
        else:
            todo.append((i, point))

    attempts: dict[str, int] = {p.key: 0 for _, p in todo}

    def record_attempt(point: SweepPoint) -> int:
        a = attempts[point.key]
        attempts[point.key] = a + 1
        if journal is not None:
            journal.log("attempt", sweep=sweep.name, point=point.key,
                        label=point.label, attempt=a)
        return a

    def settle(point: SweepPoint, outcome: dict) -> PointResult | None:
        """Store and journal one attempt's outcome: the final
        PointResult, or None when the point is to be retried."""
        n = attempts[point.key]
        if not outcome.get("error"):
            res = _append_outcome(store, point, outcome)
            res.attempts = n
            if journal is not None:
                journal.log("done", sweep=sweep.name, point=point.key,
                            label=point.label, attempt=n - 1,
                            run_id=res.run_id)
            return res
        err = outcome["error"]
        reason = err.strip().splitlines()[-1] if err.strip() else "unknown"
        if journal is not None:
            journal.log("fail", sweep=sweep.name, point=point.key,
                        label=point.label, attempt=n - 1, reason=reason)
        if n <= retries:
            return None
        if journal is not None:
            journal.log("quarantine", sweep=sweep.name, point=point.key,
                        label=point.label, attempt=n - 1, reason=reason)
        return PointResult(point, error=err, attempts=n, quarantined=True)

    opts = (sweep.iters, sweep.warmup, cache_dir, sweep.name)
    tail = (str(dev) if dev is not None else device, tune_store)

    if workers == 0:
        for i, point in todo:
            while True:
                a = record_attempt(point)
                outcome = _point_job(point.to_dict(), *opts, i, a, False,
                                     *tail)
                res = settle(point, outcome)
                if res is not None:
                    break
                time.sleep(backoff_s * (2 ** a))
            results.append(res)
            say(_ok_line(res) if res.ok else f"[FAIL] {point.label}")
    else:
        by_dev: dict[int, list[tuple[int, SweepPoint]]] = {}
        for i, point in todo:
            by_dev.setdefault(point.n_devices, []).append((i, point))
        for n_devices, group in sorted(by_dev.items()):
            n_workers = min(workers, len(group))
            label_of = {p.key: p.label for _, p in group}
            cards = _group_cards(dev, n_devices)
            # inside a worker its first pinned card is cuda:0
            job_tail = ("cuda" if cards else tail[0], tune_store)
            with SupervisedPool(_point_job, n_workers,
                                init=_worker_init, initargs=(cards,),
                                deadline_s=deadline_s) as pool:
                pending = list(group)
                rnd = 0
                while pending:
                    tasks = []
                    for i, point in pending:
                        a = record_attempt(point)
                        tasks.append((point.key, (point.to_dict(), *opts,
                                                  i, a, True, *job_tail)))
                    outcomes = pool.run(
                        tasks,
                        on_event=lambda kind, key: say(
                            f"[watchdog] {label_of[key]}: {kind}"))
                    retry = []
                    for i, point in pending:
                        out = outcomes[point.key]
                        if out.kind == "ok" and out.error is None:
                            outcome = out.value or {"error": "empty worker "
                                                             "reply"}
                        else:
                            outcome = {"error": out.error or out.kind}
                        res = settle(point, outcome)
                        if res is None:
                            retry.append((i, point))
                            continue
                        results.append(res)
                        say(_ok_line(res) if res.ok
                            else f"[FAIL] {point.label}")
                    if retry:
                        time.sleep(backoff_s * (2 ** min(rnd, 6)))
                    pending = retry
                    rnd += 1
    # campaign order (configs outermost), not completion order
    order = {p.key: i for i, p in enumerate(points)}
    results.sort(key=lambda r: order[r.point.key])
    return SweepResult(results, skipped)


def _ok_line(res: PointResult) -> str:
    if res.resumed:
        return f"[ok] {res.point.label} -> run {res.run_id} (resumed)"
    tag = " (cached)" if res.cached else ""
    wall = (f" wall {res.wall_s*1e3:.3f} ms" if res.wall_s else " bound-only")
    return f"[ok] {res.point.label} -> run {res.run_id}{wall}{tag}"
