"""Training loop: checkpoint/restart, straggler detection, fault
tolerance (port of ``repro.train.trainer``).

The step is :func:`repro_torch.train.step.make_train_step`; the loop
carries the reference's operational features:

* **restart** — on construction the trainer restores the newest
  checkpoint under ``ckpt_dir`` that verifies, skipping corrupt or
  half-written ones into ``TrainReport.skipped_ckpts``, and resumes at
  its step (the data stream is a pure function of the step);
* **async checkpointing** every ``ckpt_every`` steps and at the end;
* **straggler detection** — an EWMA of step walls; a step slower than
  ``straggler_factor`` × the EWMA is recorded in ``stragglers``;
* **preemption safety** — SIGTERM sets a flag; the loop checkpoints and
  stops at the next step boundary;
* **fault tolerance** — transient step faults are retried with
  exponential backoff, and the checkpointer's ``healthy()`` is polled
  each log interval so a dead writer fails the run promptly.

Differences from the reference:

* an explicit ``device`` in place of ``mesh`` / ``state_shardings`` /
  ``batch_shardings`` (sharding belongs to the multi-GPU slice).  A
  fresh state is ``init_state(model, run,
  torch.Generator(device).manual_seed(seed), device)``; a restore reads
  onto ``device`` against a template on ``meta`` (the reference's
  ``jax.eval_shape``);
* ``make_batch`` returns numpy arrays (``repro_torch.data.pipeline``) or
  tensors; the trainer puts them on ``device``, and with ``prefetch > 0``
  makes them on a :class:`~repro_torch.data.pipeline.Prefetcher` thread
  (pinned memory, non-blocking copy) from the step it starts at;
* determinism on the card.  The reference's step is a pure function of
  (state, batch), so a retried step and a resumed run repeat it bit for
  bit.  On CUDA some kernels add with atomics in a varying order —
  DeepCAM's bilinear upsample backward (``upsample_bilinear2d_backward``)
  is one: two clean DeepCAM runs part after one step (``PERF.md``).  So
  with ``deterministic`` (the default) the loop runs under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, restored
  after it: ops with a deterministic implementation take it (cuDNN's
  convs too; DeepCAM's resize takes its own,
  ``models.deepcam._DeterministicResize``), the others warn.  cuBLAS
  wants ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before its first product
  (``launch.train`` sets it), or it warns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Callable

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import Prefetcher, to_device
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.resilience import faults
from repro_torch.train.step import TrainState, init_state, make_train_step


@dataclasses.dataclass
class TrainReport:
    steps: int = 0
    losses: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)
    restarts: int = 0
    resumed_from: int | None = None
    retries: int = 0                 # transient step faults retried past
    skipped_ckpts: list = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(self, model: Model, run: RunConfig,
                 make_batch: Callable[[int], dict],
                 ckpt_dir: str | None = None,
                 ckpt_every: int = 50,
                 lr: float = 3e-4,
                 device: str | torch.device = "cuda",
                 straggler_factor: float = 2.0,
                 seed: int = 0,
                 ckpt_keep: int = 3,
                 step_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 prefetch: int = 0,
                 deterministic: bool = True):
        self.model, self.run = model, run
        self.make_batch = make_batch
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.device = resolve_device(device)
        self.straggler_factor = straggler_factor
        self.step_retries = step_retries
        self.retry_backoff_s = retry_backoff_s
        self.prefetch = prefetch
        self.deterministic = deterministic
        self.report = TrainReport()
        self._stop = False
        self._async_ckpt = ckpt.AsyncCheckpointer(keep=ckpt_keep)
        self._put_batch = to_device(self.device)
        self.step_fn = make_train_step(model, run, lr=lr)
        self.state = self._init_or_resume(seed)

    # -------------------------------------------------------------------
    def _init_or_resume(self, seed: int) -> TrainState:
        if self.ckpt_dir is not None:
            steps = ckpt.available_steps(self.ckpt_dir)
            if steps:
                like = init_state(self.model, self.run, None, "meta")
                # newest first; skip anything corrupt or half-written —
                # resuming from an older verified checkpoint beats dying
                for step in reversed(steps):
                    try:
                        state, meta = ckpt.restore(self.ckpt_dir, like,
                                                   step=step,
                                                   device=self.device)
                    except (ckpt.CheckpointCorrupt, OSError, KeyError,
                            ValueError) as e:
                        self.report.skipped_ckpts.append((step, repr(e)))
                        continue
                    self.report.resumed_from = int(meta.get("step", step))
                    self.report.restarts += 1
                    return state
        gen = torch.Generator(self.device).manual_seed(seed)
        return init_state(self.model, self.run, gen, self.device)

    # -------------------------------------------------------------------
    def _install_sigterm(self) -> None:
        def handler(_sig, _frm):
            self._stop = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:                       # not on the main thread
            pass

    @contextlib.contextmanager
    def _determinism(self):
        """Deterministic algorithms for the loop, on the card."""
        if not (self.deterministic and self.device.type == "cuda"):
            yield
            return
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])

    def _step_resilient(self, i: int, batch: dict,
                        log: Callable[[str], None],
                        plan: "faults.FaultPlan"):
        """One train step with fault hooks and transient-fault retry.

        The faults fire before the step runs (it updates the state in
        place), so a retry recomputes the same step from the same state.
        """
        attempts = self.step_retries + 1
        for attempt in range(attempts):
            try:
                plan.maybe_crash("crash_step", target=i)
                plan.maybe_raise("step_fault", target=i)
                return self.step_fn(self.state, batch)
            except faults.TransientFault as e:
                if attempt + 1 >= attempts:
                    raise
                self.report.retries += 1
                delay = self.retry_backoff_s * (2 ** attempt)
                log(f"[trainer] transient fault at step {i} "
                    f"(attempt {attempt + 1}/{attempts}): {e}; "
                    f"retrying in {delay:g}s")
                time.sleep(delay)
        raise AssertionError("unreachable")

    def fit(self, n_steps: int, log_every: int = 10,
            log: Callable[[str], None] = print) -> TrainReport:
        self._install_sigterm()
        ewma = None
        start_step = int(self.state.step)
        pf = (Prefetcher(self.make_batch, start_step, self.prefetch,
                         transform=self._put_batch)
              if self.prefetch > 0 and start_step < n_steps else None)
        try:
            with self._determinism():
                plan = faults.active_plan()
                for i in range(start_step, n_steps):
                    if self._stop:
                        log(f"[trainer] SIGTERM at step {i}; checkpointing")
                        break
                    if pf is not None:
                        got, batch = pf.next()
                        if got != i:
                            raise RuntimeError(f"prefetcher gave step {got} "
                                               f"at step {i}")
                    else:
                        batch = self._put_batch(self.make_batch(i))
                    t0 = time.perf_counter()
                    self.state, metrics = self._step_resilient(i, batch,
                                                               log, plan)
                    loss = float(metrics["loss"])   # waits for the step
                    dt = time.perf_counter() - t0

                    # straggler detection (per-step heartbeat timing)
                    if ewma is not None and dt > self.straggler_factor * ewma:
                        self.report.stragglers.append((i, dt, ewma))
                    ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt

                    self.report.steps += 1
                    self.report.losses.append(loss)
                    self.report.step_times.append(dt)
                    if log_every and i % log_every == 0:
                        log(f"[trainer] step {i:5d} loss {loss:.4f} "
                            f"({dt*1e3:.1f} ms, grad_norm "
                            f"{float(metrics['grad_norm']):.3f})")
                        if not self._async_ckpt.healthy():
                            log(f"[trainer] checkpoint writer failed; "
                                f"surfacing at step {i}")
                            self._async_ckpt.wait()  # raises the error
                    if (self.ckpt_dir is not None and self.ckpt_every
                            and (i + 1) % self.ckpt_every == 0):
                        self._async_ckpt.save(self.ckpt_dir, i + 1,
                                              self.state, {"step": i + 1})
        finally:
            if pf is not None:
                pf.close()
        if self.ckpt_dir is not None:
            step = int(self.state.step)
            self._async_ckpt.save(self.ckpt_dir, step, self.state,
                                  {"step": step})
            self._async_ckpt.wait()
        return self.report

    @property
    def checkpoint_walls(self) -> list[tuple[int, float]]:
        """(step, seconds) of each checkpoint write completed so far."""
        return list(self._async_ckpt.write_walls)
