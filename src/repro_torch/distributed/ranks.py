"""Ranks of a real process group on this host, one process each.

:func:`launch` starts ``world`` processes (``python -m
repro_torch.distributed.ranks``), each of which joins one process group
on ``127.0.0.1`` (gloo on the host's CPU, NCCL with rank ``r`` on card
``r``) and calls the same function ``module:function(rank, world,
payload)``; rank 0's return value comes back as JSON.  It is the host's
counterpart of the reference's forced host devices: a collective here
moves real bytes between real processes.

The ranks are plain subprocesses, so a supervised pool worker (a
daemonic process, which may not have multiprocessing children) can start
them.  Nothing outlives its launcher:

* every rank's process group has a timeout, so a rank whose peer died
  raises out of its collective instead of blocking;
* every rank watches its parent and exits when the parent is gone (a
  launcher killed at a deadline leaves no orphan blocked in gloo);
* :func:`launch` waits with a deadline and kills every rank still alive
  when it returns or raises.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any

#: how often a rank checks that its launcher is alive, seconds
_WATCH_S = 0.5


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the group's rendezvous)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _src_dir() -> str:
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def launch(target: str, payload: Any, world: int, *, backend: str = "gloo",
           timeout_s: float = 300.0) -> Any:
    """Run ``target`` (``"module:function"``) on ``world`` ranks of a
    ``backend`` group and return rank 0's result.

    ``payload`` and the result must be JSON values.  Raises
    ``RuntimeError`` with the tail of each failed rank's log when a rank
    exits non-zero, or when the ranks run past ``timeout_s`` (the
    group's own timeout too)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_src_dir(), env.get("PYTHONPATH")) if p)
    if backend == "gloo":
        env["CUDA_VISIBLE_DEVICES"] = ""       # the host's CPU, no card
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as d:
        spec = os.path.join(d, "spec.json")
        out = os.path.join(d, "out.json")
        with open(spec, "w") as f:
            json.dump({"target": target, "payload": payload, "world": world,
                       "backend": backend, "port": free_port(),
                       "timeout_s": timeout_s, "out": out}, f)
        procs = []
        try:
            for rank in range(world):
                log = open(os.path.join(d, f"rank{rank}.log"), "w")
                with log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.distributed.ranks",
                         spec, str(rank)],
                        env=env, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            codes = [None] * world
            while any(c is None for c in codes):
                for i, p in enumerate(procs):
                    codes[i] = p.poll()
                failed = [i for i, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    why = (f"rank(s) {failed} exited "
                           f"{[codes[i] for i in failed]}" if failed else
                           f"ranks still running after {timeout_s:g} s")
                    raise RuntimeError(
                        f"{target} on {world} {backend} rank(s): {why}\n"
                        + _logs(d, failed or range(world)))
                time.sleep(0.05)
            with open(out) as f:
                return json.load(f)["result"]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def _logs(d: str, ranks) -> str:
    parts = []
    for r in ranks:
        try:
            with open(os.path.join(d, f"rank{r}.log")) as f:
                text = f.read()
        except OSError:
            continue
        parts.append(f"--- rank {r} ---\n{text[-3000:]}")
    return "\n".join(parts)


def _watch_parent() -> None:
    """Exit this rank when its launcher is gone."""
    parent = os.getppid()

    def loop():
        while True:
            time.sleep(_WATCH_S)
            if os.getppid() != parent:
                os._exit(3)
    threading.Thread(target=loop, daemon=True).start()


def _rank_main(spec_path: str, rank: int) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    _watch_parent()
    with open(spec_path) as f:
        spec = json.load(f)
    world, backend = spec["world"], spec["backend"]
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout_s"]))
    try:
        mod, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(
            rank, world, spec["payload"])
        if rank == 0:
            tmp = f"{spec['out']}.tmp"
            with open(tmp, "w") as f:
                json.dump({"result": result}, f)
            os.replace(tmp, spec["out"])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
