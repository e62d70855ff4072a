"""Session: the paper's workflow as one object (port of
``repro.session.session``) — characterize the machine, characterize the
application against it, record measured runs, run whole campaigns, and
read the history back::

    characterize → profile → record → serve → sweep → report → compare
                                                → trend → advise → merge

``Session(device=...)`` defaults to ``"cuda"`` and raises when there is
no CUDA device; pass ``device="cpu"`` to run the plain PyTorch versions
on the host.  ``profile`` and ``record`` build a registry config's fwd,
bwd and opt phases (``repro_torch.train.step.make_phases``) at any
``fusion`` mode, ``attn_impl`` ``"einsum"``, ``"chunked"`` or ``"flash"``
(the attention families: dense, MoE, VLM — its patch embeddings in the
batch — and enc-dec — its encoder frames), ``ssd_impl`` ``"xla"`` or
``"kernel"`` (SSM, hybrid) and ``impl`` ``"reference"`` or ``"fused"``
(DeepCAM, on its image batch).  ``serve`` takes a dense or MoE config.
Records go to the workspace's trace store
(:class:`~repro_torch.session.workspace.Workspace`), in the reference's
schema; so does ``serve``, which drives the continuous-batching engine
(``repro_torch.serve``) over a seeded arrival trace and records its
prefill and decode phases.  ``sweep`` runs a campaign of points
(``repro_torch.sweep``) into the workspace's sweep store; ``trend``,
``advise`` and ``merge`` read the stores (``repro_torch.obs``).
``tune`` searches kernel launch configs, and (``dispatch=True``) the
fused-vs-reference dispatch table, into the workspace's tune store;
``profile``, ``record``, ``sweep`` and ``characterize`` read that store
under the session's machine key (``fusion="auto"`` routes by its
dispatch table, the kernels launch with its winners).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.utils._pytree import tree_map

from repro_torch.core.machine import (CPU_HOST, MachineSpec, datasheet_for,
                                      get_machine)
from repro_torch.device import (DEFAULT_DEVICE, device_label,
                                 resolve_device)
from repro_torch.session.result import (RooflineResult, payload_from_profile,
                                        phases_from_record)
from repro_torch.session.workspace import Workspace

#: phases of one training step, in execution order (the paper's split)
TRAIN_PHASES = ("fwd", "bwd", "opt")
#: seed of the random weights and tokens of a measured registry profile
SEED = 0


def _matmul_class(run: Any) -> str | None:
    return "bf16" if run.compute_dtype == torch.bfloat16 else None


class Session:
    """One analysis session: a machine model on one device.

    ``machine`` is a :class:`MachineSpec`, a registry name, or ``None``
    for the datasheet spec of the device (``cpu-host`` on the host);
    ``workspace`` is a :class:`Workspace`, a root path, or ``None`` for
    the default root (``REPRO_WORKSPACE`` > ``./.repro-workspace`` in a
    checkout > ``~/.repro``).
    """

    def __init__(self, machine: MachineSpec | str | None = None,
                 device: str | torch.device = DEFAULT_DEVICE,
                 workspace: Workspace | str | None = None):
        self.device = resolve_device(device)
        if machine is None:
            machine = (datasheet_for(torch.cuda.get_device_name(self.device))
                       if self.device.type == "cuda" else CPU_HOST)
        self.machine = (machine if isinstance(machine, MachineSpec)
                        else get_machine(machine))
        self.workspace = (workspace if isinstance(workspace, Workspace)
                          else Workspace(workspace))

    def __repr__(self) -> str:
        return (f"Session(machine={self.machine.name!r}, "
                f"device={str(self.device)!r}, "
                f"workspace={self.workspace.root!r})")

    def _provenance(self, **extra: Any) -> dict[str, Any]:
        return {"device": device_label(self.device),
                "machine": self.machine.name, "torch": torch.__version__,
                **extra}

    def _scope(self):
        """Bind the workspace's tune store, the session's machine key and
        device for the dispatch table and the kernels' tuned configs."""
        from repro_torch.tune.dispatch import dispatch_scope
        return dispatch_scope(store=self.workspace.tune_store,
                              machine=self.machine.name, device=self.device)

    # -- 1. machine characterization (paper §II-A) -----------------------
    def characterize(self, empirical: bool = False, tuned: bool = True,
                     smoke: bool = False) -> RooflineResult:
        """Machine model: datasheet, or measured ERT ceilings of the device
        (which then becomes the session's machine).  ``tuned=True`` takes
        each ceiling from the best-of-tuned winners in the workspace's tune
        store (searched once, store hits after); ``tuned=False`` times the
        default launch configs once."""
        if empirical:
            from repro_torch.kernels.ert.ops import characterize
            self.machine = characterize(
                self.device, tuned=tuned, smoke=smoke, machine=self.machine,
                store=self.workspace.tune_store)
        self.workspace.write_header(self.machine.name)
        from repro_torch.core.report import machine_table
        return RooflineResult(
            kind="characterize", name=self.machine.name,
            machine=self.machine,
            provenance=self._provenance(
                empirical=empirical,
                tune_store=self.workspace.tune_path if empirical and tuned
                else None),
            text=machine_table(self.machine))

    # -- 2. application characterization (paper §II-B) -------------------
    def profile(self, target: str | Callable, args: Sequence[Any] = (),
                *, phases: Sequence[str] = TRAIN_PHASES,
                seq: int = 32, batch: int = 4, amp: str = "O1",
                fusion: str = "off", attn_impl: str = "einsum",
                ssd_impl: str = "xla", impl: str = "reference",
                remat: str = "none", optimizer: str = "adamw",
                smoke: bool = True, n_layers: int | None = None,
                measure: bool = False, iters: int = 5,
                warmup: int = 2) -> RooflineResult:
        """Aten-op walk of a registry config's phases — or of *your* torch
        function (pass a callable + ``args``).

        ``n_layers`` cuts (or sets) the depth of the config, keeping its
        widths; ``attn_impl``, ``ssd_impl``, ``impl``, ``remat`` and
        ``optimizer`` fill ``RunConfig``'s (``seq`` is not read for
        DeepCAM, whose images
        take the config's resolution).
        ``measure=True`` also runs the same callable on the session's
        device (parameters drawn there from seed :data:`SEED`) and
        attributes the measured time over its kernels; without it the walk
        runs on meta tensors and allocates nothing, even at full width.
        """
        with self._scope():
            return self._profile(target, args, phases=phases, seq=seq,
                                 batch=batch, amp=amp, fusion=fusion,
                                 attn_impl=attn_impl, ssd_impl=ssd_impl,
                                 impl=impl, remat=remat, optimizer=optimizer,
                                 smoke=smoke, n_layers=n_layers,
                                 measure=measure, iters=iters, warmup=warmup)

    def _profile(self, target, args, *, phases, seq, batch, amp, fusion,
                 attn_impl, ssd_impl, impl, remat, optimizer, smoke,
                 n_layers, measure, iters, warmup) -> RooflineResult:
        from repro_torch.core.profiler import profile_fn

        if callable(target):
            label = getattr(target, "__name__", "fn")
            phase_args: Mapping[str, tuple] = {label: (target, tuple(args))}
            mm = None
        else:
            label = target
            phase_args, run = build_phases(
                target, phases=phases, seq=seq, batch=batch, amp=amp,
                fusion=fusion, attn_impl=attn_impl, ssd_impl=ssd_impl,
                impl=impl, remat=remat, optimizer=optimizer, smoke=smoke,
                n_layers=n_layers,
                device=self.device if measure else torch.device("meta"))
            mm = _matmul_class(run)

        results = {ph: profile_fn(fn, args=a, name=ph, machine=self.machine,
                                  measure=measure, measure_iters=iters,
                                  measure_warmup=warmup, matmul_class=mm)
                   for ph, (fn, a) in phase_args.items()}
        if measure:
            from repro_torch.trace.collector import measurement_from_profile
            from repro_torch.trace.store import phase_payload
            payloads = {ph: phase_payload(
                measurement_from_profile(res, self.machine))
                for ph, res in results.items()}
        else:
            payloads = {ph: payload_from_profile(res)
                        for ph, res in results.items()}
        return RooflineResult(
            kind="profile", name=label, machine=self.machine,
            provenance=self._provenance(measured=measure),
            phases=payloads,
            analyses={ph: res.analysis for ph, res in results.items()},
            data=results)

    # -- 3. measured trace into the store (time-based roofline) ----------
    def record(self, config: str, *, seq: int = 32, batch: int = 4,
               amp: str = "O1", fusion: str = "off",
               attn_impl: str = "einsum", ssd_impl: str = "xla",
               impl: str = "reference", remat: str = "none",
               optimizer: str = "adamw", smoke: bool = True,
               n_layers: int | None = None, iters: int = 5, warmup: int = 2,
               scale_wall: float = 1.0,
               meta: Mapping[str, Any] | None = None) -> RooflineResult:
        """Measure one config's train phases on the session's device and
        append a provenance-stamped record to the workspace trace store.

        ``scale_wall`` multiplies the measured wall times before storing
        (regression drills).  ``n_layers`` cuts the depth as in
        :meth:`profile`.  The meta stamps what the workspace's tune store
        held under the session's machine key, as the reference's does:
        ``kernel_configs`` and the measured ``dispatch_table``.  The
        reference's ``net_ceilings`` waits for the network level.
        """
        from repro_torch.tune.dispatch import active_dispatch_table
        from repro_torch.tune.store import active_kernel_configs
        from repro_torch.trace.collector import (measurement_from_profile,
                                                 scale_measurement)
        from repro_torch.trace.store import record_from_phases
        from repro_torch.trace.timeline import ascii_timeline, build_timeline

        prof = self.profile(config, seq=seq, batch=batch, amp=amp,
                            fusion=fusion, attn_impl=attn_impl,
                            ssd_impl=ssd_impl, impl=impl, remat=remat,
                            optimizer=optimizer, smoke=smoke,
                            n_layers=n_layers, measure=True, iters=iters,
                            warmup=warmup)
        ms = {ph: scale_measurement(measurement_from_profile(
            res, self.machine), scale_wall)
            for ph, res in prof.data.items()}
        rec = record_from_phases(
            config, ms, machine=self.machine.name,
            meta={"smoke": smoke, "seq": seq, "batch": batch, "amp": amp,
                  "fusion": fusion, "attn_impl": attn_impl,
                  "ssd_impl": ssd_impl, "impl": impl, "remat": remat,
                  "optimizer": optimizer, "n_layers": n_layers,
                  "scale_wall": scale_wall,
                  "device": self._provenance()["device"],
                  "kernel_configs": active_kernel_configs(
                      machine=self.machine.name,
                      store=self.workspace.tune_store),
                  "dispatch_table": active_dispatch_table(
                      machine=self.machine.name,
                      store=self.workspace.tune_store),
                  **dict(meta or {})})
        self.workspace.trace_store.append(rec)
        self.workspace.write_header(self.machine.name)
        return RooflineResult(
            kind="record", name=config, machine=self.machine,
            provenance=self._provenance(run_id=rec.run_id,
                                        store=self.workspace.trace_path),
            phases=phases_from_record(rec),
            text=ascii_timeline(build_timeline(ms)),
            data=rec)

    # -- 3b. serving under load (continuous batching, repro_torch.serve) --
    def serve(self, config: str, *, n_requests: int = 16,
              trace: str = "poisson", rate: float = 1.0, burst: int = 4,
              seed: int = 0, n_slots: int = 4, max_len: int = 64,
              prefill_chunk: int = 16, page_size: int = 16,
              prompt_len: tuple[int, int] = (4, 16),
              max_new: tuple[int, int] = (4, 16),
              amp: str = "O1", fusion: str = "off", smoke: bool = True,
              max_ticks: int = 4096,
              meta: Mapping[str, Any] | None = None) -> RooflineResult:
        """Serve a seeded synthetic arrival trace through the continuous-
        batching engine on the session's device and record prefill and
        decode as *separate* phase payloads in the trace store (config
        key ``serve/<name>``).

        Parameters are drawn on the device from ``seed``, which also
        seeds the trace (request for request the reference's trace).  The
        engine's executables — the callables it timed — are walked on
        meta tensors and their envelopes scaled by their call counts, so
        the record says per serving phase where the time goes.
        ``analyses`` holds each executable's one-call walk; ``data`` is
        ``(record, stats, engine, requests)``.  ``exit_code`` is 1 when the latency
        gate fails (a wedged scheduler, an admitted request that never
        finished).
        """
        with self._scope():
            return self._serve(
                config, n_requests=n_requests, trace=trace, rate=rate,
                burst=burst, seed=seed, n_slots=n_slots, max_len=max_len,
                prefill_chunk=prefill_chunk, page_size=page_size,
                prompt_len=prompt_len, max_new=max_new, amp=amp,
                fusion=fusion, smoke=smoke, max_ticks=max_ticks, meta=meta)

    def _serve(self, config, *, n_requests, trace, rate, burst, seed,
               n_slots, max_len, prefill_chunk, page_size, prompt_len,
               max_new, amp, fusion, smoke, max_ticks, meta
               ) -> RooflineResult:
        from repro_torch.configs.base import RunConfig
        from repro_torch.configs.registry import get_config, get_smoke
        from repro_torch.models import api as M
        from repro_torch.models.params import init
        from repro_torch.serve.engine import Engine
        from repro_torch.serve.trace import executable_profiles, serve_record
        from repro_torch.serve.workload import make_trace
        from repro_torch.tune.dispatch import active_dispatch_table
        from repro_torch.tune.store import active_kernel_configs

        cfg = get_smoke(config) if smoke else get_config(config)
        run = RunConfig(amp=amp, fusion=fusion)
        model = M.build(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init(model.spec, gen, run.param_dtype, self.device)
        engine = Engine(cfg, run, params, n_slots=n_slots, max_len=max_len,
                        page_size=page_size, prefill_chunk=prefill_chunk,
                        device=self.device)
        pl = (min(prompt_len[0], max_len), min(prompt_len[1], max_len))
        kw = {"burst": burst} if trace == "bursty" else {}
        reqs = make_trace(trace, n_requests, rate=rate, seed=seed,
                          vocab=cfg.vocab_size, prompt_len=pl,
                          max_new=max_new, **kw)
        stats = engine.run_trace(reqs, max_ticks=max_ticks)
        mm = _matmul_class(run)
        profiles = executable_profiles(engine, self.machine, mm)
        rec = serve_record(
            config, engine, stats, self.machine, matmul_class=mm,
            profiles=profiles,
            meta={"smoke": smoke, "amp": amp, "fusion": fusion,
                  "trace": trace, "n_requests": n_requests,
                  "n_slots": n_slots, "max_len": max_len,
                  "prefill_chunk": engine.chunk, "page_size": page_size,
                  "seed": seed, "device": self._provenance()["device"],
                  "kernel_configs": active_kernel_configs(
                      machine=self.machine.name,
                      store=self.workspace.tune_store),
                  "dispatch_table": active_dispatch_table(
                      machine=self.machine.name,
                      store=self.workspace.tune_store),
                  **dict(meta or {})})
        self.workspace.trace_store.append(rec)
        self.workspace.write_header(self.machine.name)
        problems = stats.gate()
        text = stats.render()
        if problems:
            text += "\n" + "\n".join(f"GATE: {p}" for p in problems)
        return RooflineResult(
            kind="record", name=f"serve/{config}", machine=self.machine,
            provenance=self._provenance(run_id=rec.run_id,
                                        store=self.workspace.trace_path),
            phases=phases_from_record(rec),
            analyses={name: res.analysis for name, res in profiles.items()},
            text=text, data=(rec, stats, engine, reqs),
            exit_code=1 if problems else 0)

    # -- 4. read back without re-running ---------------------------------
    def report(self, config: str | None = None) -> RooflineResult:
        """Newest stored record for ``config`` (or the newest record of
        any config) from the workspace trace store."""
        recs = self.workspace.trace_store.last(config, n=1)
        if not recs:
            which = f"config {config!r}" if config else "any config"
            raise LookupError(
                f"no records for {which} in {self.workspace.trace_path} — "
                "run Session.record() (or `python -m repro_torch record`) "
                "first")
        rec = recs[0]
        machine = (self.machine if rec.machine == self.machine.name
                   else get_machine(rec.machine))
        from repro_torch.trace.timeline import (ascii_timeline,
                                                timeline_from_record)
        return RooflineResult(
            kind="report", name=rec.config, machine=machine,
            provenance=self._provenance(run_id=rec.run_id,
                                        git_sha=rec.git_sha,
                                        store=self.workspace.trace_path),
            phases=phases_from_record(rec),
            text=ascii_timeline(timeline_from_record(rec)),
            data=rec)

    # -- 5. regressions between stored runs -------------------------------
    def compare(self, config: str | None = None, *, base: str | None = None,
                new: str | None = None, threshold: float = 0.10,
                window: int = 2) -> RooflineResult:
        """Diff stored runs: the newest of each config against the run
        ``window - 1`` records before it, or two explicit run ids (``base``
        and ``new``, prefixes allowed); ``exit_code`` is 1 when any cell
        regressed past ``threshold``."""
        from repro_torch.trace.compare import (compare_last, compare_records,
                                               format_deltas, has_regressions)
        store = self.workspace.trace_store
        if base or new:
            if not (base and new):
                raise ValueError("base and new run ids go together")
            b, n = store.run(base), store.run(new)
            if b is None or n is None:
                raise LookupError(
                    f"run id not found in {self.workspace.trace_path}")
            deltas = compare_records(b, n, threshold)
        else:
            deltas = compare_last(store, config, threshold, window=window)
        return RooflineResult(
            kind="compare", name=config or "all", machine=self.machine,
            provenance=self._provenance(store=self.workspace.trace_path,
                                        threshold=threshold),
            text=format_deltas(deltas), data=deltas,
            exit_code=1 if has_regressions(deltas) else 0)

    # -- 5b. cross-config campaigns ----------------------------------------
    def sweep(self, spec: Any = None, *, smoke: bool = False,
              workers: int | None = None,
              progress: Callable[[str], None] | None = None,
              resume: bool = False, deadline_s: float | None = None,
              retries: int = 1, **axes: Any) -> RooflineResult:
        """Run a campaign into the workspace's sweep store and summarize.

        Pass a :class:`~repro_torch.sweep.spec.SweepSpec`, ``smoke=True``
        for the CI preset, or the axes as keywords (``configs=("glm4-9b",),
        seqs=(16,), amps=("O0", "O1")``...).  The bounds are against the
        session's machine (the preset takes its name too), measured
        points run on the session's device and launch with the
        workspace's tune store.  ``resume``, ``deadline_s`` and
        ``retries`` go to :func:`repro_torch.sweep.engine.run_sweep` (the
        journal lies beside the sweep store).
        """
        from repro_torch.sweep.aggregate import (latest_per_point,
                                                 render_summary,
                                                 sweep_records)
        from repro_torch.sweep.engine import run_sweep
        from repro_torch.sweep.spec import (SweepSpec, normalize_axes,
                                            smoke_spec)

        if spec is None:
            if smoke:
                spec = dataclasses.replace(smoke_spec(),
                                           machine=self.machine.name)
            else:
                spec = SweepSpec(machine=self.machine.name,
                                 **normalize_axes(dict(axes)))
        elif axes:
            raise TypeError(f"pass axes ({sorted(axes)}) or a spec, "
                            "not both")
        result = run_sweep(spec, store_path=self.workspace.sweep_path,
                           cache_dir=self.workspace.sweep_cache_dir,
                           workers=workers, progress=progress,
                           resume=resume, deadline_s=deadline_s,
                           retries=retries, device=str(self.device),
                           tune_store=self.workspace.tune_path)
        self.workspace.write_header(self.machine.name)
        recs = latest_per_point(sweep_records(self.workspace.sweep_store,
                                              spec.name))
        return RooflineResult(
            kind="sweep", name=spec.name, machine=self.machine,
            provenance=self._provenance(store=self.workspace.sweep_path,
                                        n_ok=result.n_ok,
                                        n_failed=result.n_failed),
            text=render_summary(recs) if recs else "(no points stored)",
            data=result,
            exit_code=1 if result.n_failed else 0)

    # -- 6. kernel autotuning and the dispatch table ---------------------
    def tune(self, kernels: Sequence[str] | None = None, *,
             backend: str | None = None, smoke: bool = False,
             ceilings: bool = False, force: bool = False, iters: int = 3,
             warmup: int = 1, dispatch: bool = False,
             config: str = "glm4-9b", seq: int = 16, batch: int = 2,
             amp: str = "O1", full: bool = False,
             n_layers: int | None = None,
             attn_impl: str = "einsum") -> RooflineResult:
        """Search kernel launch configs into the workspace's tune store
        under the session's machine key (a point already stored is a pure
        hit: nothing is timed).

        ``backend`` is ``"cuda"`` (the hand-written kernels; the default on
        the card) or ``"torch"`` (the plain versions; the default on the
        host).  The points follow who reads the winners
        (:func:`repro_torch.tune.search.tune_workload`): the fused kernels
        at every (shape, dtype) ``config``'s train step launches them at
        (the smoke variant unless ``full``; ``seq``, ``batch``, ``amp``,
        ``n_layers`` and ``attn_impl`` as in :meth:`profile`), the ERT
        kernels through the ceiling searches of ``characterize(tuned=True)``
        (also run for ``ceilings`` or ``smoke``), the flash and SSD spaces
        only when named.  ``smoke`` picks the small candidate grids and
        ceiling sizes.  ``dispatch=True`` instead measures every dispatch
        site of ``config``'s train step at ``fusion="auto"``: a second call
        over the same workspace measures nothing.
        """
        store = self.workspace.tune_store
        step = dict(seq=seq, batch=batch, amp=amp, n_layers=n_layers,
                    attn_impl=attn_impl, device=self.device)
        if dispatch:
            from repro_torch.tune.dispatch import search_sites
            outcome = search_sites(
                config, machine=self.machine.name, store=store, iters=iters,
                warmup=warmup, smoke=not full, force=force, **step)
            self.workspace.write_header(self.machine.name)
            return RooflineResult(
                kind="tune", name=f"dispatch/{config}", machine=self.machine,
                provenance=self._provenance(
                    store=self.workspace.tune_path, n_sites=outcome.n_sites,
                    n_measured=outcome.n_measured),
                text=outcome.describe(), data=outcome)
        from repro_torch.tune.search import tune_workload
        backend = backend or ("cuda" if self.device.type == "cuda"
                              else "torch")
        outcomes = tune_workload(
            kernels, backend=backend, machine=self.machine.name, store=store,
            config=config, full=full, ceilings=ceilings, iters=iters,
            warmup=warmup, smoke=smoke, force=force, **step)
        self.workspace.write_header(self.machine.name)
        return RooflineResult(
            kind="tune", name=",".join(kernels or (backend,)),
            machine=self.machine,
            provenance=self._provenance(store=self.workspace.tune_path,
                                        n_winners=len(list(store.keys()))),
            text="\n".join(o.describe() for o in outcomes.values()),
            data=outcomes)


    # -- 7. observability: trend / advise / merge (repro_torch.obs) -------
    def trend(self, config: str | None = None, *, gate: bool = False,
              tolerance: float | None = None, baseline: str | None = None,
              bench_dirs: Sequence[str] | None = None,
              max_rows: int = 40) -> RooflineResult:
        """Perf-trend series over the workspace's history (trace and sweep
        records, the ``BENCH_*.json`` of its ``bench/`` and of
        ``bench_dirs``) as sparklines; ``gate=True`` sets ``exit_code`` 1
        when a lower-is-better series regressed past the tolerance.
        ``baseline`` (a tag or a run id, :meth:`trend_tag`) pins the gate
        to a known-good run instead of the rolling median."""
        from repro_torch.obs.trend import (DEFAULT_TOLERANCE, collect_series,
                                           gate_series, render_trend)
        series = collect_series(self.workspace, config,
                                bench_dirs=bench_dirs)
        baseline_run = (self.workspace.resolve_tag(baseline)
                        if baseline else None)
        regressions = gate_series(
            series, tolerance if tolerance is not None
            else DEFAULT_TOLERANCE,
            baseline_run=baseline_run) if gate else None
        return RooflineResult(
            kind="trend", name=config or "all", machine=self.machine,
            provenance=self._provenance(n_series=len(series), gated=gate,
                                        baseline=baseline_run),
            text=render_trend(series, regressions, max_rows=max_rows),
            data=(series, regressions or []),
            exit_code=1 if regressions else 0)

    def trend_tag(self, name: str, run_id: str | None = None
                  ) -> RooflineResult:
        """Pin a run under a tag in the workspace header, so that
        ``trend(gate=True, baseline=name)`` anchors to it; ``run_id``
        defaults to the newest trace record, a prefix is looked up in the
        trace then the sweep store."""
        if run_id is None:
            recs = self.workspace.trace_store.last(n=1)
            if not recs:
                raise LookupError(
                    f"no records in {self.workspace.trace_path} to tag — "
                    "run `python -m repro_torch record` first")
            rec = recs[0]
        else:
            rec = (self.workspace.trace_store.run(run_id)
                   or self.workspace.sweep_store.run(run_id))
            if rec is None:
                raise LookupError(
                    f"run {run_id!r} not found in the workspace trace or "
                    "sweep stores")
        self.workspace.tag_run(name, rec.run_id)
        return RooflineResult(
            kind="trend", name=f"tag/{name}", machine=self.machine,
            provenance=self._provenance(run_id=rec.run_id),
            text=f"tagged run {rec.run_id} ({rec.config}) as {name!r} — "
                 f"gate against it with `python -m repro_torch trend "
                 f"--gate --baseline {name}`",
            data={"tag": name, "run_id": rec.run_id})

    def advise(self, config: str | None = None, *, top: int = 0
               ) -> RooflineResult:
        """Mine the stored records for known bottleneck patterns: ranked,
        evidence-cited findings (``repro_torch.obs.advisor``)."""
        from repro_torch.obs.advisor import advise, render_findings
        findings = advise(self.workspace, config, machine=self.machine.name)
        return RooflineResult(
            kind="advise", name=config or "all", machine=self.machine,
            provenance=self._provenance(n_findings=len(findings)),
            text=render_findings(findings, top=top), data=findings)

    def merge(self, remote_root: str) -> RooflineResult:
        """Union another workspace's stores into this one (run id, tune
        key and harvest-file dedupe; conflicts skipped and reported; the
        provenance appended to ``workspace.json``)."""
        from repro_torch.obs.merge import merge_workspace, render_merge
        reports = merge_workspace(self.workspace, remote_root)
        return RooflineResult(
            kind="merge", name=remote_root, machine=self.machine,
            provenance=self._provenance(
                added={r.store: r.n_added for r in reports}),
            text=render_merge(reports, self.workspace.root, remote_root),
            data=reports)


def build_phases(config: str, *, phases: Sequence[str], seq: int,
                 batch: int, amp: str, fusion: str, attn_impl: str,
                 ssd_impl: str, smoke: bool, n_layers: int | None,
                 device: torch.device, impl: str = "reference",
                 remat: str = "none", optimizer: str = "adamw"):
    """({phase: (fn, args)}, run) for a registry config: real tensors on
    ``device`` (parameters and batch drawn from seed :data:`SEED`), or
    meta tensors that allocate nothing.  Gradients and the state of
    ``optimizer`` are built only when the opt phase is asked for; its
    gradients are zeros, as the reference's, and it updates the params in
    place.  A ``cnn``
    config (DeepCAM) takes its image batch at the config's resolution and
    the lowering ``impl`` (``fusion="auto"`` upgrades ``reference`` to
    ``fused``, :func:`repro_torch.models.deepcam.resolve_impl`)."""
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.models import api as M
    from repro_torch.models.params import init
    from repro_torch.train import optim
    from repro_torch.train.step import make_phases

    for ph in phases:
        if ph not in TRAIN_PHASES:
            raise ValueError(f"unknown phase {ph!r}; valid: {TRAIN_PHASES}")
    cfg = get_smoke(config) if smoke else get_config(config)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    run = RunConfig(amp=amp, fusion=fusion, attn_impl=attn_impl,
                    ssd_impl=ssd_impl, impl=impl, remat=remat,
                    optimizer=optimizer)
    model = M.build(cfg)
    concrete = device.type != "meta"
    gen = (torch.Generator(device=device).manual_seed(SEED)
           if concrete else None)
    params = init(model.spec, gen, run.param_dtype, device)
    batch_t = M.synthetic_batch(cfg, ShapeSpec("trace", seq, batch, "train"),
                                batch, gen, device)

    fns = make_phases(model, run)
    out = {}
    for ph in phases:
        if ph == "opt":
            args = (params, tree_map(torch.zeros_like, params),
                    optim.optimizer_init(params, run))
        else:
            args = (params, batch_t)
        out[ph] = (fns[ph], args)
    return out, run
