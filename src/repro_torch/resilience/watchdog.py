"""Supervised worker pool: per-task deadlines, kill and replace (port of
``repro.resilience.watchdog``).

``concurrent.futures.ProcessPoolExecutor`` cannot kill one hung task: a
worker stuck in a CUDA call or a native hang wedges the pool and the
campaign with it.  :class:`SupervisedPool` owns its workers directly:

* each worker is a *spawned* process (a forked child of a process that
  has initialized CUDA cannot use the card) with a private duplex pipe;
  it runs an optional initializer (the sweep engine's card pin), says it
  is ready, then serves one task at a time;
* the parent polls every pipe with a timeout and tracks when each task
  was dispatched; a task past ``deadline_s`` has its worker killed
  (terminate, a grace period, kill) and **replaced**, and is reported as
  a ``timeout``;
* a worker that dies mid-task (a segfault, an OOM kill, an injected
  ``os._exit``) is found by its pipe's EOF or its liveness and reported
  as a ``crash`` with its exit code; a replacement is spawned.

Retry, backoff and quarantine belong to the caller
(``repro_torch.sweep.engine``): the pool only answers what happened to
one attempt, so it can supervise any picklable job.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from multiprocessing import connection
from typing import Any, Callable, Sequence

#: how long a terminate() gets before kill()
_GRACE_S = 1.0
#: pipe poll quantum; also bounds how late a deadline is noticed
_POLL_S = 0.1


@dataclasses.dataclass
class Outcome:
    """What happened to one dispatched task."""

    kind: str                       # "ok" | "crash" | "timeout"
    value: Any = None               # the worker's return (kind == "ok")
    error: str | None = None
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.kind == "ok"


class _Worker:
    """The parent's handle on one supervised process."""

    def __init__(self, ctx, target, args):
        self.conn, child_conn = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(target=target,
                                args=(child_conn, *args), daemon=True)
        self.proc.start()
        child_conn.close()
        self.ready = False
        self.init_error: str | None = None
        self.t_spawn = time.monotonic()
        self.task: tuple[Any, float] | None = None    # (task_id, t0)

    def kill(self) -> None:
        try:
            self.proc.terminate()
            self.proc.join(_GRACE_S)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(_GRACE_S)
        finally:
            try:
                self.conn.close()
            except OSError:
                pass


def _child_main(conn, init, initargs, worker_fn) -> None:
    """The worker's loop: init once, then one task at a time until told
    to stop."""
    try:
        if init is not None:
            init(*initargs)
        conn.send(("ready", None, None))
    except BaseException:
        try:
            conn.send(("init_error", None, traceback.format_exc()))
        except OSError:
            pass
        return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg[0] == "stop":
            return
        _, task_id, args = msg
        try:
            payload = {"value": worker_fn(*args)}
        except BaseException:
            payload = {"error": traceback.format_exc()}
        try:
            conn.send(("done", task_id, payload))
        except OSError:
            return


class SupervisedPool:
    """Run picklable tasks on supervised workers with a per-task deadline.

    ``worker_fn``, ``init`` and every task argument must be picklable at
    module scope: the workers are spawned, never forked.
    """

    def __init__(self, worker_fn: Callable, n_workers: int, *,
                 init: Callable | None = None, initargs: tuple = (),
                 deadline_s: float | None = None,
                 mp_context: str = "spawn"):
        import multiprocessing
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.worker_fn = worker_fn
        self.n_workers = n_workers
        self.init, self.initargs = init, initargs
        self.deadline_s = deadline_s
        self._ctx = multiprocessing.get_context(mp_context)
        self._workers: list[_Worker] = []
        self._spawns = 0
        self.replacements = 0       # workers killed or lost and replaced

    # -- lifecycle -------------------------------------------------------
    def __enter__(self) -> "SupervisedPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for w in self._workers:
            if w.proc.is_alive():
                try:
                    w.conn.send(("stop",))
                except OSError:
                    pass
        for w in self._workers:
            w.proc.join(_GRACE_S)
            if w.proc.is_alive():
                w.kill()
            else:
                try:
                    w.conn.close()
                except OSError:
                    pass
        self._workers = []

    def _spawn(self) -> _Worker:
        w = _Worker(self._ctx, _child_main,
                    (self.init, self.initargs, self.worker_fn))
        self._workers.append(w)
        self._spawns += 1
        return w

    # -- one batch -------------------------------------------------------
    def run(self, tasks: Sequence[tuple[Any, tuple]],
            on_event: Callable[[str, Any], None] | None = None
            ) -> dict[Any, Outcome]:
        """Run ``[(task_id, args), ...]``; returns task_id → Outcome.

        Workers live on across ``run`` calls (the engine's retry rounds
        reuse warm processes); hung or crashed ones are replaced.
        ``on_event(kind, task_id)`` is called on each ``"timeout"`` and
        ``"crash"`` as it is found.
        """
        say = on_event or (lambda kind, task_id: None)
        pending: list[tuple[Any, tuple]] = list(tasks)
        results: dict[Any, Outcome] = {}
        n_tasks = len(pending)
        if not n_tasks:
            return results
        # a plan (or a machine) that kills every worker at init must end,
        # not spawn forever
        max_spawns = self._spawns + self.n_workers + 2 * n_tasks + 4

        while len(results) < n_tasks:
            # top up the workers (no more than the remaining work needs)
            alive = [w for w in self._workers if w.proc.is_alive()]
            in_flight = sum(1 for w in alive if w.task is not None)
            want = min(self.n_workers, in_flight + len(pending))
            while len(alive) < want and self._spawns < max_spawns:
                alive.append(self._spawn())
            if not alive and pending:
                for task_id, _args in pending:
                    results[task_id] = Outcome(
                        kind="crash",
                        error="worker spawn budget exhausted "
                              "(every worker died during init?)")
                    say("crash", task_id)
                pending = []
                continue

            # dispatch to idle ready workers
            for w in alive:
                if pending and w.ready and w.task is None:
                    task_id, args = pending.pop(0)
                    try:
                        w.conn.send(("task", task_id, args))
                        w.task = (task_id, time.monotonic())
                    except OSError:            # died between two polls
                        pending.insert(0, (task_id, args))

            for conn_ready in connection.wait(
                    [w.conn for w in alive], timeout=_POLL_S):
                w = next(x for x in alive if x.conn is conn_ready)
                try:
                    msg = w.conn.recv()
                except (EOFError, OSError):
                    continue                   # the liveness sweep reaps it
                if msg[0] == "ready":
                    w.ready = True
                elif msg[0] == "init_error":
                    w.ready = False            # the liveness sweep reaps it
                    w.init_error = msg[2]
                elif msg[0] == "done":
                    _, task_id, payload = msg
                    t0 = w.task[1] if w.task else time.monotonic()
                    w.task = None
                    results[task_id] = Outcome(
                        kind="ok", value=payload.get("value"),
                        error=payload.get("error"),
                        wall_s=time.monotonic() - t0)

            # liveness and deadlines, over every tracked worker (not only
            # this round's snapshot: a worker that died between two
            # snapshots would otherwise keep its task forever)
            now = time.monotonic()
            for w in list(self._workers):
                if not w.proc.is_alive():
                    if w.task is not None:
                        task_id, t0 = w.task
                        results[task_id] = Outcome(
                            kind="crash", wall_s=now - t0,
                            error=f"worker died (exit code "
                                  f"{w.proc.exitcode}) — replaced")
                        say("crash", task_id)
                        self.replacements += 1
                    self._workers.remove(w)
                    try:
                        w.conn.close()
                    except OSError:
                        pass
                elif (self.deadline_s is not None and w.task is not None
                        and now - w.task[1] > self.deadline_s):
                    task_id, t0 = w.task
                    w.kill()
                    self._workers.remove(w)
                    results[task_id] = Outcome(
                        kind="timeout", wall_s=now - t0,
                        error=f"point exceeded its {self.deadline_s:g}s "
                              "deadline — worker killed and replaced")
                    say("timeout", task_id)
                    self.replacements += 1
                elif (self.deadline_s is not None and not w.ready
                        and w.task is None
                        and now - w.t_spawn > self.deadline_s):
                    # stuck in start-up or init: it holds no task, but
                    # left alone it would hold the slot forever
                    w.kill()
                    self._workers.remove(w)
                    self.replacements += 1
        return results
