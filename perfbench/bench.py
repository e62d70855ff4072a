"""One run of one cell: set-up, the measured window, the traced phases and
the comparison that decides ``correct``.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``configs/<config>.json``: the model's sizes, the run's settings, the
optimizer and the reference family) and a traffic mix
(``traffic/<traffic>.json``).  :class:`Cell` finds them by name.

Set-up (``setup_s``, from the harness's first line to the window):
imports, the program's model, the weights and the batch pool made on
the device from the seed, and the first :data:`check.STEPS` train steps
through the window's own step function on the first batches of the
pool.  Those steps build or load every kernel and warm every shape the
window uses, and they are the steps the reference follows: their
losses, the first gradient (read from the optimizer's first moment) and
each leaf's change are kept for the comparison.

The window runs whole train steps back to back over the rest of the
pool, cycled, and reads nothing on the host until its closing
synchronize.  A traced run then drives the same state through the
three phases of ``make_phases`` (fwd, bwd — which runs the forward
too — and opt): untraced, each phase timed by CUDA events; under
``torch.profiler`` with CUDA activity alone, for the device's busy time
and its idle gaps; and once more with CPU activity and operator shapes,
for each kernel's share of its bound.  Once the window is closed and the
program's state freed, the reference follows the same steps from the
same weights.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from perfbench import check, traffic, yardstick
from perfbench.reference import common as refc
from perfbench.trace import Trace
from perfbench.weights import Weights

ROOT = Path(__file__).resolve().parents[1]

#: iterations of the three phases in a traced run
TRACE_ITERS = 3
#: the traced run's window of the three phases, as a host annotation
TRACED = "perfbench:traced"
PHASES = ("fwd", "bwd", "opt")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    bench: dict
    root: Path

    @classmethod
    def load(cls, name: str, root: Path = ROOT,
             config: dict | None = None, mix: dict | None = None
             ) -> "Cell":
        """The cell ``name``; ``config`` and ``mix`` replace the files'
        (a test's small sizes)."""
        bench = _json(root / "BENCHMARK.json")
        work = [w for w in bench["workloads"] if w["name"] == name]
        if not work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        work = work[0]
        entry = [c for c in bench["configs"] if c["name"] == work["config"]]
        if not entry:
            raise KeyError(f"no config {work['config']!r} in BENCHMARK.json")
        cfg = config or _json(root / entry[0]["file"])
        mx = mix or _json(root / "perfbench" / "traffic"
                          / f"{work['traffic']}.json")
        lim = _json(root / "perfbench" / "limits" / f"{name}.json")
        return cls(name, work, cfg, mx, lim, bench, root)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def family(self) -> str:
        return self.config["reference"]

    def reference(self):
        return importlib.import_module(f"perfbench.reference.{self.family}")

    def optimizer(self) -> refc.AdamW:
        return refc.AdamW(**self.config["optimizer"])

    def weights(self, seed: int, device) -> Weights:
        return Weights(self.reference().layout(self.model), seed, device)

    def tokens_per_step(self) -> int:
        return int(self.mix["batch"]) * int(self.mix["seq_len"])

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell
        reports."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def _nest(flat: dict[str, torch.Tensor], order: list[str]) -> dict:
    tree: dict = {}
    for path in order:
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = flat[path]
    return tree


def _flat(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


class Program:
    """The system under test for one cell and seed: the model, its train
    state on the seed's weights, the batch pool and the train step."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.configs.base import ModelConfig, RunConfig
        from repro_torch.distributed import amp
        from repro_torch.models.api import build
        from repro_torch.models.params import leaves
        from repro_torch.train import optim
        from repro_torch.train.step import (TrainState, make_phases,
                                            make_train_step)
        self.cell, self.device = cell, torch.device(device)
        self.model = build(ModelConfig(**cell.model))
        self.run = RunConfig(**cell.config["run"])
        self.weights = cell.weights(seed, self.device)
        order = [path for path, _ in leaves(self.model.spec)]
        want = {path: tuple(p.shape) for path, p in leaves(self.model.spec)}
        if want != self.weights.shapes():
            raise ValueError(f"the program's parameters {want} are not the "
                             f"reference layout {self.weights.shapes()}")
        params = _nest(self.weights.all(), order)
        self.state = TrainState(
            params=params, opt=optim.optimizer_init(params, self.run),
            loss_scale=amp.DynLossScale.init(device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        self.pool = traffic.pool(cell.mix, int(cell.model["vocab_size"]),
                                 seed, self.device)
        lr = cell.config["optimizer"]["lr"]
        self.step = make_train_step(self.model, self.run, lr=lr)
        self.phases = make_phases(self.model, self.run, lr=lr)
        self.next = 0
        self.last = None

    def _step(self) -> None:
        batch = self.pool[self.next % len(self.pool)]
        self.state, self.last = self.step(self.state, batch)
        self.next += 1

    def follow(self, marks: list | None = None) -> refc.Readings:
        """The first :data:`check.STEPS` steps, with what the comparison
        reads of them; ``marks`` gets (what, host time) after each
        part."""
        marks = [] if marks is None else marks
        b1 = self.cell.config["optimizer"]["b1"]
        seed = self.weights.seed
        plan = refc.sample_plan(seed, _flat(self.state.params))
        losses, grads, gsamples = [], {}, {}
        for i in range(check.STEPS):
            self._step()
            losses.append(float(self.last["loss"]))
            marks.append((f"step {i + 1}", time.perf_counter()))
            if i == 0:
                for k, m in _flat(self.state.opt.mu).items():
                    g = m / (1 - b1)
                    grads[k] = _norm(g)
                    gsamples.update(refc.samples(g, plan[k]))
                    del g
                marks.append(("first gradient read", time.perf_counter()))
        change, csamples = {}, {}
        for k, p in _flat(self.state.params).items():
            d = p - self.weights.leaf(k)
            change[k] = _norm(d)
            csamples.update(refc.samples(d, plan[k]))
            del d
        marks.append(("change read", time.perf_counter()))
        return refc.Readings(losses, grads, change, gsamples, csamples)

    def warm_phases(self) -> None:
        """One call of each phase, outside any window."""
        self._phase_iter()

    def _phase_iter(self, events: dict | None = None,
                    marks: list | None = None) -> None:
        from torch.profiler import record_function
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        params = self.state.params
        grads = None
        for name in PHASES:
            if marks is not None:
                marks.append((time.time_ns(), name))
            if events is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            with record_function(f"phase:{name}"):
                if name == "fwd":
                    self.phases["fwd"](params, batch)
                elif name == "bwd":
                    grads = self.phases["bwd"](params, batch)
                else:
                    _, opt = self.phases["opt"](params, grads,
                                                self.state.opt)
                    self.state = self.state._replace(opt=opt)
                    grads = None
            if events is not None:
                end.record()
                events[name].append((start, end))

    def window(self, seconds: float) -> tuple[int, float]:
        """Train steps back to back for ``seconds`` of host time, then
        one synchronize → (steps, seconds from the first step's launch to
        the synchronize)."""
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while True:
            self._step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        return steps, time.perf_counter() - t0

    def timed_phases(self) -> dict[str, list[float]]:
        """:data:`TRACE_ITERS` iterations of the phases, untraced, each
        phase timed by CUDA events → its milliseconds per call."""
        events: dict[str, list] = {name: [] for name in PHASES}
        for _ in range(TRACE_ITERS):
            self._phase_iter(events if self.device.type == "cuda" else None)
        self._sync()
        return {name: [a.elapsed_time(b) for a, b in evs]
                for name, evs in events.items()}

    def traced(self) -> tuple[Trace, tuple[int, int], list]:
        """:data:`TRACE_ITERS` iterations of the phases under the
        profiler with CUDA activity alone, whose host cost a launch is
        small → (the trace, the traced window and the phases' starts, in
        the trace's clock: the host's wall clock in ns)."""
        from torch.profiler import ProfilerActivity, profile
        marks: list = []
        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        self._sync()
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            for _ in range(TRACE_ITERS):
                self._phase_iter(marks=marks)
            self._sync()
            t1 = time.time_ns()
        return Trace(prof.profiler.kineto_results.events()), (t0, t1), marks

    def attributed(self) -> Trace:
        """One iteration of the phases under the profiler with CPU and
        CUDA activity and operator shapes: each kernel tied to the op
        that launched it, for the kernels' shares of their bounds (the
        host runs slower under it, so its times of the host are not
        read)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        with profile(activities=acts, record_shapes=True) as prof:
            self._phase_iter()
            self._sync()
        return Trace(prof.profiler.kineto_results.events())

    def final_loss(self) -> float:
        return float(self.last["loss"]) if self.last is not None else math.nan

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        for name in ("state", "pool", "step", "phases", "last", "model"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(cell: Cell, seed: int, device,
              precision: str = "fp32") -> refc.Readings:
    """The plain reference through the same first steps, from the same
    weights and batches, in ``precision`` (``fp32``: TF32 off)."""
    fam = cell.reference()
    weights = cell.weights(seed, device)
    batches = traffic.pool(cell.mix, int(cell.model["vocab_size"]), seed,
                           device)[:check.STEPS]
    products = refc.Products(precision)
    with refc.exact_fp32():
        return refc.follow(lambda p, b: fam.loss(p, b, cell.model, products),
                           weights.all(), weights.leaf, batches,
                           cell.optimizer(), seed)


def _reader(root: Path, name: str):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        device="cuda", t0: float | None = None) -> dict:
    """One run → the result: the keys of the result line, ``checks``
    last, then ``readings``, the numbers the cell does not compare."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    prog = Program(cell, seed, dev)
    marks.append(("state and pool", time.perf_counter()))
    mine = prog.follow(marks)
    if trace:
        prog.warm_phases()
    prog._sync()
    marks.append(("warm phases", time.perf_counter()))
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    last = t0
    for name, t in marks:
        print(f"setup: {name} {t - last:.3f} s", file=sys.stderr)
        last = t

    steps, window_s = prog.window(seconds)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    final = prog.final_loss()
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    e2e = {"setup_s": setup_s,
           "train_tokens_per_s": steps * cell.tokens_per_step() / window_s,
           "peak_mem_gb": window_peak / 1e9}
    breakdown = None
    if trace:
        ms = prog.timed_phases()
        tr, span, marks = prog.traced()
        busy = tr.busy_s(*span)
        device_info["busy_s"] = busy
        device_info["window_s"] = (span[1] - span[0]) * 1e-9
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps(*span, marks=marks)}
        del tr
        # what a reader of ``metrics/<name>.py`` may read
        ctx = SimpleNamespace(
            trace=prog.attributed(), phase_ms=ms, model=cell.model,
            family=cell.family, reference=cell.reference(), mix=cell.mix,
            steps=steps,
            window_s=window_s, busy_s=busy,
            traced_s=device_info["window_s"],
            params=prog.weights.count(),
            peaks=yardstick.peaks(kind) if cuda else None)
        values = {}
        for m in cell.metrics("per_layer"):
            v = _reader(cell.root, m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        del ctx
    else:
        values = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                  for m in cell.metrics("end_to_end")}
    prog.close()
    del prog

    theirs = reference(cell, seed, dev)
    nums, where = check.numbers(mine, theirs)
    ok = check.judge(nums, cell.limits) and steps > 0 and math.isfinite(final)
    result = {"correct": ok, "attempted": steps,
              "failed": 0 if math.isfinite(final) else steps,
              "metrics": values, "device": device_info}
    if cuda:
        result["device"]["power_limit"] = _power_limit()
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {
        k: {"value": nums[k], "limit": lim["limit"],
            **({"leaf": where[k]} if k in where else {})}
        for k, lim in cell.limits.items()}
    result["checks"]["final_loss"] = {"value": final, "limit": "finite"}
    result["readings"] = {k: v for k, v in nums.items()
                          if k not in cell.limits}
    return result

