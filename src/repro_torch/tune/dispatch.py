"""Measurement-driven fusion dispatch: site-keyed fused-vs-reference
routing through the tune store (port of ``repro.tune.dispatch``).

Under ``RunConfig.fusion = "auto"`` (alias ``"measured"``) every eligible
fused call site builds a :class:`DispatchKey` (op, shapes, dtypes, flags,
machine) and asks :func:`decide`.  The first encounter of a site times
the fused implementation against the plain chain it replaces, both
directions (the timed function is the forward plus ``torch.autograd.grad``
of the sum of its outputs in fp32; AdamW is timed forward only), and
persists the winner in the tune store's ``dispatch`` namespace.  Every
later encounter is a store lookup.  Key strings are the reference's for
the same op, shapes, dtypes and flags (dtype names are numpy's, and a
(B, S, D) activation is the (B·S, D) site), so one store serves both
packages.

PyTorch runs eagerly, so a site is asked on every call, not once per
trace: a stored verdict costs one memoized dict lookup
(:func:`repro_torch.tune.store.lookup`), and a site is measured again
only under ``force`` (once per scope).

A miss is measured on concrete inputs built from the key on the device of
the call (the scope's device when the call runs on ``meta`` tensors, as
the op walk and :func:`search_sites` do), with autograd on and outside
any active ``TorchDispatchMode``, so an op walk records none of the
measurement's ops.  A miss while a CUDA graph is being captured raises.

``REPRO_DISPATCH`` picks the miss policy:

* ``measure`` (default) — time fused vs reference, persist the winner;
* ``static``  — no timing: an eligible site routes fused;
* ``frozen``  — raise :class:`DispatchMiss` (every site must have been
  measured beforehand).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch

from repro_torch.tune.space import STEP_KERNELS, torch_dtype
from repro_torch.tune.store import (DEFAULT_MACHINE, SCHEMA_VERSION,
                                    TuneStore, _as_store, active_store, bind,
                                    bound, lookup, machine_for)

#: miss policies, resolution order: explicit arg > scope > env > default
DISPATCH_ENV = "REPRO_DISPATCH"
MODES = ("measure", "static", "frozen")

#: eps of a measured norm site (the reference's)
SITE_EPS = 1e-5


class DispatchMiss(LookupError):
    """Raised under ``REPRO_DISPATCH=frozen`` for an unmeasured site."""


# --------------------------------------------------------------------------
# Keys and records
# --------------------------------------------------------------------------

def dtype_name(dtype: Any) -> str:
    """numpy's name of a torch dtype (or of a name): ``bfloat16``."""
    return str(dtype).removeprefix("torch.")


def _shape2(shape: Sequence[int]) -> tuple[int, int]:
    """(..., d) → (rows, d): (B, S, D) and (B·S, D) are one site."""
    d = int(shape[-1])
    rows = int(math.prod(shape[:-1])) if len(shape) > 1 else 1
    return (rows, d)


@dataclasses.dataclass(frozen=True)
class DispatchKey:
    """One fused call site: op + normalized shapes/dtypes + flags."""

    op: str
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]
    flags: tuple[tuple[str, str], ...] = ()
    machine: str = DEFAULT_MACHINE

    @property
    def key(self) -> str:
        shapes = ",".join("x".join(str(d) for d in s) for s in self.shapes)
        flags = ",".join(f"{k}={v}" for k, v in self.flags) or "-"
        return (f"dispatch|{self.op}|{shapes}|{','.join(self.dtypes)}"
                f"|{flags}|{self.machine}")

    @property
    def flag_dict(self) -> dict[str, str]:
        return dict(self.flags)


def make_key(op: str, shapes: Iterable[Sequence[int]],
             dtypes: Iterable[Any], flags: Mapping[str, Any] | None = None,
             machine: str | None = None) -> DispatchKey:
    return DispatchKey(
        op=op,
        shapes=tuple(tuple(int(d) for d in s) for s in shapes),
        dtypes=tuple(dtype_name(dt) for dt in dtypes),
        flags=tuple(sorted((str(k), str(v))
                           for k, v in (flags or {}).items())),
        machine=machine or machine_for())


@dataclasses.dataclass
class DispatchRecord:
    """One measured site: both walls, the winner, and provenance (the
    reference's fields, with ``torch_version`` for its ``jax_version``)."""

    schema_version: int
    key: str
    op: str
    shapes: list[list[int]]
    dtypes: list[str]
    flags: dict[str, str]
    machine: str
    impl: str                     # "fused" | "reference" — the winner
    fused_wall_s: float
    ref_wall_s: float
    iters: int
    timestamp: float
    git_sha: str
    torch_version: str
    host: dict[str, str]

    @property
    def speedup(self) -> float:
        """Winner-over-loser wall improvement (≥ 1 by construction)."""
        lo = min(self.fused_wall_s, self.ref_wall_s)
        hi = max(self.fused_wall_s, self.ref_wall_s)
        return hi / lo if lo else 1.0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DispatchRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for name, dflt in (("schema_version", 0), ("key", ""), ("op", "?"),
                           ("shapes", []), ("dtypes", []), ("flags", {}),
                           ("machine", DEFAULT_MACHINE),
                           ("impl", "reference"), ("fused_wall_s", 0.0),
                           ("ref_wall_s", 0.0), ("iters", 0),
                           ("timestamp", 0.0), ("git_sha", "unknown"),
                           ("torch_version", "unknown"), ("host", {})):
            kw.setdefault(name, dflt)
        return cls(**kw)

    def to_key(self) -> DispatchKey:
        return DispatchKey(self.op, tuple(tuple(s) for s in self.shapes),
                           tuple(self.dtypes),
                           tuple(sorted(self.flags.items())), self.machine)

    def describe(self) -> str:
        shapes = ",".join("x".join(map(str, s)) for s in self.shapes)
        return (f"{self.op:<14} {shapes:<18} "
                f"fused {self.fused_wall_s * 1e6:9.1f}us vs ref "
                f"{self.ref_wall_s * 1e6:9.1f}us -> {self.impl} "
                f"({self.speedup:.2f}x)")


# --------------------------------------------------------------------------
# Scope: store / mode / machine / device / timer bindings and the counters
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Scope:
    mode: str | None = None
    timer: Callable[..., float] | None = None
    iters: int = 3
    warmup: int = 1
    force: bool = False
    # the sites asked (key string → key); "n_measured" is what a second
    # search over the same workspace must keep at 0
    sites: dict = dataclasses.field(default_factory=dict)
    n_measured: int = 0
    n_hit: int = 0
    n_static: int = 0
    # sites re-measured under ``force`` in this scope (once each)
    forced: set = dataclasses.field(default_factory=set)
    # tuned-config lookups noted by a kernel that launches for many sites
    # at once (:func:`note_points`); a list only where :func:`step_points`
    # collects them, shared with the scopes nested in its own
    points: list | None = None

    def reset_stats(self) -> None:
        self.sites, self.forced = {}, set()
        self.n_measured = self.n_hit = self.n_static = 0


_SCOPE = _Scope()


@contextlib.contextmanager
def dispatch_scope(store: TuneStore | str | None = None,
                   mode: str | None = None, machine: str | None = None,
                   device: str | torch.device | None = None,
                   timer: Callable[..., float] | None = None,
                   iters: int | None = None, warmup: int | None = None,
                   force: bool = False):
    """Bind the miss policy and timer of every :func:`decide` in the
    ``with`` body, and (through :func:`repro_torch.tune.store.bind`) the
    store, machine key and measuring device of every lookup there, the
    kernel wrappers' tuned configs included; unset arguments inherit the
    enclosing scope's.  On exit the scope's counters are added to the
    enclosing scope's, so a caller's scope also counts what the scopes
    nested in it (``Session.profile``'s, for one) decided."""
    global _SCOPE
    prev = _SCOPE
    _SCOPE = _Scope(
        mode=mode if mode is not None else prev.mode,
        timer=timer if timer is not None else prev.timer,
        iters=iters if iters is not None else prev.iters,
        warmup=warmup if warmup is not None else prev.warmup,
        force=force or prev.force, points=prev.points)
    inner = _SCOPE
    try:
        with bind(store, machine, device):
            yield inner
    finally:
        _SCOPE = prev
        prev.sites |= inner.sites
        prev.n_measured += inner.n_measured
        prev.n_hit += inner.n_hit
        prev.n_static += inner.n_static


def _resolve_mode(mode: str | None = None) -> str:
    mode = mode or _SCOPE.mode or os.environ.get(DISPATCH_ENV, "measure")
    if mode not in MODES:
        raise ValueError(f"unknown {DISPATCH_ENV} mode {mode!r}; "
                         f"valid: {', '.join(MODES)}")
    return mode


# --------------------------------------------------------------------------
# Lookup + routing
# --------------------------------------------------------------------------

def get_record(key: DispatchKey | str,
               store: TuneStore | str | None = None
               ) -> DispatchRecord | None:
    st = _as_store(store) if store is not None else active_store()
    d = st.get_dispatch(key.key if isinstance(key, DispatchKey) else key)
    return DispatchRecord.from_dict(d) if d is not None else None


def best_impl(key: DispatchKey | str,
              store: TuneStore | str | None = None) -> str | None:
    """Stored winner of a site, ``None`` on a miss (never measures)."""
    rec = get_record(key, store)
    return rec.impl if rec is not None else None


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def decide(key: DispatchKey, *, device: torch.device | None = None,
           store: TuneStore | str | None = None,
           mode: str | None = None) -> str:
    """``"fused"`` or ``"reference"`` for one eligible site.

    Stored → the stored winner (one memoized lookup).  Miss → the policy:
    measure on ``device`` (time both, persist), static (fused), or frozen
    (raise :class:`DispatchMiss`).  Under ``force`` a site is measured
    again once per scope.
    """
    scope = _SCOPE
    k = key.key
    scope.sites[k] = key
    mode = _resolve_mode(mode)
    st = _as_store(store) if store is not None else active_store()
    if not (scope.force and mode == "measure") or k in scope.forced:
        d = lookup(st, "dispatch", k)
        if d is not None:
            scope.n_hit += 1
            return d.get("impl", "reference")
    if mode == "static":
        scope.n_static += 1
        return "fused"
    if mode == "frozen":
        raise DispatchMiss(
            f"{DISPATCH_ENV}=frozen and no dispatch entry for {k!r} — run "
            "`python -m repro_torch tune dispatch search` first")
    if _capturing():
        raise RuntimeError(f"dispatch site {k!r} is not in the store and a "
                           "CUDA graph is being captured: measure it first "
                           "(tune dispatch search)")
    rec = measure_site(key, store=st, device=device)
    scope.forced.add(k)
    return rec.impl


def site_walls(key: DispatchKey, *, device: torch.device | None = None
               ) -> tuple[float, float] | None:
    """(fused, reference) walls of one eligible site: :func:`decide` first
    (it records the site and, on a miss, measures or raises as the policy
    says), then the stored record; None where the policy left none
    (``static``)."""
    decide(key, device=device)
    d = lookup(active_store(), "dispatch", key.key)
    return None if d is None else (float(d.get("fused_wall_s", 0.0)),
                                   float(d.get("ref_wall_s", 0.0)))


# --------------------------------------------------------------------------
# Measurement: fused vs reference
# --------------------------------------------------------------------------

def _default_timer(impl: str, fn: Callable, args: tuple, iters: int,
                   warmup: int) -> float:
    """Min over ``iters`` samples, CUDA events on the card (the host clock
    on the host), after ``warmup`` calls."""
    del impl
    from repro_torch.core.profiler import args_device
    from repro_torch.tune.search import time_min
    return time_min(lambda: fn(*args), args_device(args), iters, warmup)


def _measure_device(device: torch.device | None) -> torch.device:
    if device is not None and device.type != "meta":
        return device
    bound_dev = bound().device
    if bound_dev is not None and bound_dev.type != "meta":
        return bound_dev
    from repro_torch.device import DEFAULT_DEVICE, resolve_device
    return resolve_device(DEFAULT_DEVICE)


def site_candidates(key: DispatchKey, device: str | torch.device = "cpu"
                    ) -> dict[str, tuple[Callable, tuple]]:
    """{impl: (fn, concrete args on ``device``)} for one site, rebuilt
    from its key."""
    builder = _SITE_BUILDERS.get(key.op)
    if builder is None:
        raise KeyError(f"no dispatch site builder for op {key.op!r} "
                       f"(known: {', '.join(sorted(_SITE_BUILDERS))})")
    return builder(key, torch.device(device))


def measure_site(key: DispatchKey, *,
                 store: TuneStore | str | None = None,
                 device: torch.device | None = None,
                 iters: int | None = None, warmup: int | None = None,
                 timer: Callable[..., float] | None = None
                 ) -> DispatchRecord:
    """Time fused vs reference for one site on ``device`` (the scope's for
    a ``meta`` or missing one), persist and return the record."""
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.trace.store import git_sha, host_fingerprint
    scope = _SCOPE
    st = _as_store(store) if store is not None else active_store()
    iters = iters if iters is not None else scope.iters
    warmup = warmup if warmup is not None else scope.warmup
    timer = timer or scope.timer or _default_timer
    dev = _measure_device(device)
    with _disable_current_modes(), torch.enable_grad():
        cands = site_candidates(key, dev)
        walls = {impl: float(timer(impl, fn, args, iters, warmup))
                 for impl, (fn, args) in cands.items()}
        del cands
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    winner = min(walls, key=walls.get)
    rec = DispatchRecord(
        schema_version=SCHEMA_VERSION, key=key.key, op=key.op,
        shapes=[list(s) for s in key.shapes], dtypes=list(key.dtypes),
        flags=key.flag_dict, machine=key.machine, impl=winner,
        fused_wall_s=walls["fused"], ref_wall_s=walls["reference"],
        iters=iters, timestamp=time.time(), git_sha=git_sha(),
        torch_version=torch.__version__, host=host_fingerprint())
    st.put_dispatch_many({rec.key: rec.to_dict()})
    scope.n_measured += 1
    return rec


# --------------------------------------------------------------------------
# Per-op key builders (called from kernels/fused/ops.py) + measurement
# candidate builders (called from measure_site)
# --------------------------------------------------------------------------

def norm_key(x, scale, bias=None, *, kind: str = "rmsnorm",
             out_dtype=None) -> DispatchKey:
    shapes = [_shape2(x.shape)]
    if kind == "rmsnorm_residual":
        shapes.append(_shape2(x.shape))           # the residual stream
    shapes.append((int(x.shape[-1]),))            # scale (and bias)
    return make_key("fused_norm", shapes, (x.dtype, scale.dtype),
                    {"kind": kind, "out": dtype_name(out_dtype or x.dtype)},
                    machine_for(x.device))


def swiglu_key(gate, up, *, act: str = "silu",
               out_dtype=None) -> DispatchKey:
    return make_key("fused_swiglu",
                    (_shape2(gate.shape), _shape2(up.shape)),
                    (gate.dtype, up.dtype),
                    {"act": act, "out": dtype_name(out_dtype or gate.dtype)},
                    machine_for(gate.device))


def adamw_key(p, m) -> DispatchKey:
    """Keyed by the leaf's size: a stacked (n_layers, ...) leaf's site
    depends on the depth."""
    return make_key("fused_adamw", ((int(p.numel()),),), (p.dtype, m.dtype),
                    machine=machine_for(p.device))


def embed_key(table, tokens, compute_dtype) -> DispatchKey:
    return make_key("embed_grad",
                    (tuple(int(d) for d in table.shape),
                     (int(tokens.numel()),)),
                    (table.dtype, tokens.dtype),
                    {"compute": dtype_name(compute_dtype)},
                    machine_for(table.device))


def flash_key(q_shape: Sequence[int], k_shape: Sequence[int], dtype,
              *, chunk: int, device: torch.device | None = None
              ) -> DispatchKey:
    return make_key("flash_attn",
                    (tuple(int(d) for d in q_shape),
                     tuple(int(d) for d in k_shape)),
                    (dtype,), {"chunk": int(chunk)}, machine_for(device))


def _fill(seed: int, shape: Sequence[int], dtype: str,
          device: torch.device) -> torch.Tensor:
    """Concrete measurement input: normal floats, ids for integers."""
    dt = torch_dtype(dtype)
    if not dt.is_floating_point:
        n = int(math.prod(shape))
        return (torch.arange(n, device=device) % 97).to(dt).reshape(shape)
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=g, device=device).to(dt)


def _grad_wrapped(f: Callable, argnums: Sequence[int]) -> Callable:
    """The forward plus ``torch.autograd.grad`` of the fp32 sum of its
    outputs with respect to ``argnums``: one wall for both directions,
    through exactly the backward the model would run."""

    def run(*args):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() if i in argnums else a
                      for i, a in enumerate(args)]
            out = f(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            loss = sum(o.float().sum() for o in outs)
            grads = torch.autograd.grad(loss, [leaves[i] for i in argnums])
        return loss.detach(), grads

    return run


def _pair(fused: Callable, ref: Callable, args: tuple,
          argnums: Sequence[int] | None = None
          ) -> dict[str, tuple[Callable, tuple]]:
    argnums = tuple(range(len(args))) if argnums is None else tuple(argnums)
    return {"fused": (_grad_wrapped(fused, argnums), args),
            "reference": (_grad_wrapped(ref, argnums), args)}


def _norm_site(key: DispatchKey, dev: torch.device):
    from repro_torch.kernels.fused import norm as nk
    from repro_torch.kernels.fused import ops as fops
    flags = key.flag_dict
    kind = flags.get("kind", "rmsnorm")
    out = torch_dtype(flags.get("out", key.dtypes[0]))
    rows, d = key.shapes[0]
    xdt, sdt = key.dtypes[0], key.dtypes[-1]
    x = _fill(0, (rows, d), xdt, dev)
    scale = _fill(1, (d,), sdt, dev)
    eps = SITE_EPS
    if kind == "rmsnorm_residual":
        h = _fill(2, (rows, d), xdt, dev)
        return _pair(
            lambda a, b, s: fops.rmsnorm_residual(a, b, s, eps=eps,
                                                  out_dtype=out),
            lambda a, b, s: nk.rmsnorm_residual_ref(a, b, s, eps, out),
            (x, h, scale))
    if kind == "layernorm":
        bias = _fill(2, (d,), sdt, dev)
        return _pair(
            lambda a, s, b: fops.layernorm(a, s, b, eps=eps, out_dtype=out),
            lambda a, s, b: nk.layernorm_ref(a, s, b, eps, out),
            (x, scale, bias))
    return _pair(lambda a, s: fops.rmsnorm(a, s, eps=eps, out_dtype=out),
                 lambda a, s: nk.rmsnorm_ref(a, s, eps, out), (x, scale))


def _swiglu_site(key: DispatchKey, dev: torch.device):
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.kernels.fused import swiglu as sk
    flags = key.flag_dict
    act = flags.get("act", "silu")
    out = torch_dtype(flags.get("out", key.dtypes[0]))
    rows, d = key.shapes[0]
    g = _fill(0, (rows, d), key.dtypes[0], dev)
    u = _fill(1, (rows, d), key.dtypes[1], dev)
    return _pair(lambda a, b: fops.swiglu(a, b, act=act, out_dtype=out),
                 lambda a, b: sk.swiglu_ref(a, b, act, out), (g, u))


def _adamw_site(key: DispatchKey, dev: torch.device):
    """Forward only (the optimizer is not differentiated), in place, as
    the train step updates a leaf: the kernel, or the plain chain and
    three copies."""
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.kernels.fused.adamw import adamw_ref
    n = int(key.shapes[0][0])
    pdt, mdt = key.dtypes[0], key.dtypes[-1]
    g = _fill(0, (n,), pdt, dev)
    m = _fill(1, (n,), mdt, dev)
    v = _fill(2, (n,), mdt, dev).abs()
    p = _fill(3, (n,), pdt, dev)
    bc = torch.tensor([0.1, 0.1], dtype=torch.float32, device=dev)
    hp = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)

    def fused(g_, m_, v_, p_, bc_):
        return fops.adamw_group([g_], [m_], [v_], [p_], bc_, inplace=True,
                                **hp)

    def ref(g_, m_, v_, p_, bc_):
        for dst, src in zip((p_, m_, v_), adamw_ref(g_, m_, v_, p_, bc_,
                                                    **hp)):
            dst.copy_(src)
        return p_, m_, v_

    args = (g, m, v, p, bc)
    return {"fused": (fused, args), "reference": (ref, args)}


def _embed_site(key: DispatchKey, dev: torch.device):
    """Gradient with respect to the table only: the backward (a one-hot
    matmul against an index scatter) is the point."""
    from repro_torch.kernels.fused import ops as fops
    vocab, d = key.shapes[0]
    (n_tok,) = key.shapes[1]
    cd = torch_dtype(key.flag_dict.get("compute", "float32"))
    table = _fill(0, (vocab, d), key.dtypes[0], dev)
    tokens = _fill(1, (n_tok,), key.dtypes[1], dev) % vocab
    return _pair(lambda t, tok: fops.embed_with_onehot_grad(t, tok, cd),
                 lambda t, tok: t.to(cd)[tok], (table, tokens),
                 argnums=(0,))


def _flash_site(key: DispatchKey, dev: torch.device):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L
    q_shape, k_shape = key.shapes
    S = q_shape[1]
    chunk = int(key.flag_dict.get("chunk", 1024))
    q = _fill(0, q_shape, key.dtypes[0], dev)
    k = _fill(1, k_shape, key.dtypes[0], dev)
    v = _fill(2, k_shape, key.dtypes[0], dev)
    pos = torch.arange(S, device=dev)

    def ref(q_, k_, v_):
        if S > chunk and S % chunk == 0:
            return L._sdpa_chunked(q_, k_, v_, pos, pos, True, chunk)
        return L._sdpa(q_, k_, v_, pos, pos, True)

    return _pair(fa_ops.flash_attention_gqa, ref, (q, k, v))


_SITE_BUILDERS: dict[str, Callable[[DispatchKey, torch.device],
                                   dict[str, tuple[Callable, tuple]]]] = {
    "fused_norm": _norm_site,
    "fused_swiglu": _swiglu_site,
    "fused_adamw": _adamw_site,
    "embed_grad": _embed_site,
    "flash_attn": _flash_site,
}


# --------------------------------------------------------------------------
# Whole-workload search (the CLI / Session.tune(dispatch=True) surface)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DispatchSearchOutcome:
    """What one ``tune dispatch search`` pass did."""

    config: str
    n_sites: int                  # distinct sites the phases encountered
    n_measured: int               # sites timed this pass
    n_hit: int                    # store hits
    records: list[DispatchRecord]

    @property
    def all_cached(self) -> bool:
        return self.n_measured == 0

    def describe(self) -> str:
        lines = [f"dispatch search [{self.config}]: {self.n_sites} "
                 f"site(s), {self.n_measured} measured, "
                 f"{self.n_hit} store hit(s)"]
        lines += ["  " + r.describe() for r in self.records]
        return "\n".join(lines)


def _run_step_on_meta(config: str, *, seq: int, batch: int, amp: str,
                      smoke: bool, n_layers: int | None, attn_impl: str,
                      ssd_impl: str) -> None:
    """Run ``config``'s fwd / bwd / opt phases on ``meta`` tensors (nothing
    is allocated for the model) under ``fusion="auto"``: every dispatch
    site of the step asks :func:`decide` in the caller's scope."""
    from repro_torch.session.session import TRAIN_PHASES, build_phases
    phases, _ = build_phases(
        config, phases=TRAIN_PHASES, seq=seq, batch=batch, amp=amp,
        fusion="auto", attn_impl=attn_impl, ssd_impl=ssd_impl, smoke=smoke,
        n_layers=n_layers, device=torch.device("meta"))
    for fn, args in phases.values():
        fn(*args)


def search_sites(config: str = "glm4-9b", *, seq: int = 16, batch: int = 2,
                 amp: str = "O1", machine: str | None = None,
                 store: TuneStore | str | None = None, iters: int = 3,
                 warmup: int = 1, smoke: bool = True, force: bool = False,
                 timer: Callable[..., float] | None = None,
                 n_layers: int | None = None, attn_impl: str = "einsum",
                 ssd_impl: str = "xla",
                 device: str | torch.device = "cuda"
                 ) -> DispatchSearchOutcome:
    """Measure every dispatch site one config's train step encounters.

    Runs the phases on ``meta`` tensors with the miss policy ``measure``;
    each site hits the store or is measured on ``device`` and persisted,
    so a second search over the same store measures nothing.
    ``n_layers`` cuts the depth: the AdamW sites' keys hold the stacked
    leaves' sizes, so search at the depth the step runs.
    """
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    with dispatch_scope(store=store, mode="measure",
                        machine=machine or machine_for(dev), device=dev,
                        timer=timer, iters=iters, warmup=warmup,
                        force=force) as scope:
        scope.reset_stats()
        _run_step_on_meta(config, seq=seq, batch=batch, amp=amp,
                          smoke=smoke, n_layers=n_layers,
                          attn_impl=attn_impl, ssd_impl=ssd_impl)
        st = active_store()
        recs = [DispatchRecord.from_dict(d)
                for k, d in sorted(st.dispatch_records().items())
                if k in scope.sites]
        return DispatchSearchOutcome(
            config=config, n_sites=len(scope.sites),
            n_measured=scope.n_measured, n_hit=scope.n_hit, records=recs)


def tune_point(key: DispatchKey) -> tuple[str, tuple[int, ...], str] | None:
    """(kernel, shape, dtype) of the tuned-config lookup that a site's
    kernel makes when it launches (``kernels/config.py::for_launch``):
    the first operand's (rows, d), and its dtype.  ``None`` for an op
    whose kernel reads no winner (``space.STEP_KERNELS``: the flash
    kernel's tiles are compiled, the embedding has no kernel), and for an
    AdamW leaf: the leaves that route to the kernel launch together, with
    one lookup per dtype group (:func:`note_points`)."""
    if key.op not in STEP_KERNELS or key.op == "fused_adamw":
        return None
    return key.op, key.shapes[0], key.dtypes[0]


def note_points(points: Callable[[], list]) -> None:
    """Add ``points()``, (kernel, shape, dtype) lookups that one launch
    makes for many sites (the AdamW group's, at its size class), to
    what :func:`step_points` collects; nothing (``points`` not called)
    outside it."""
    if _SCOPE.points is not None:
        _SCOPE.points += points()


def step_points(config: str = "glm4-9b", *, seq: int = 16, batch: int = 2,
                amp: str = "O1", machine: str | None = None,
                store: TuneStore | str | None = None, smoke: bool = True,
                n_layers: int | None = None, attn_impl: str = "einsum",
                ssd_impl: str = "xla",
                device: str | torch.device = "cuda"
                ) -> list[tuple[str, tuple[int, ...], str]]:
    """The distinct (kernel, shape, dtype) points at which ``config``'s
    train step launches the kernels of ``space.STEP_KERNELS`` at
    ``fusion="auto"``: the phases run on ``meta`` tensors with the miss
    policy ``static``, so a site the store routes to ``reference``
    launches nothing and a site it lacks counts as fused.  Nothing is
    measured.  The AdamW leaves that route to the kernel launch together:
    their points are the ones the step's group calls note."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    with dispatch_scope(store=store, mode="static",
                        machine=machine or machine_for(dev),
                        device=dev) as scope:
        scope.reset_stats()
        scope.points = noted = []
        _run_step_on_meta(config, seq=seq, batch=batch, amp=amp,
                          smoke=smoke, n_layers=n_layers,
                          attn_impl=attn_impl, ssd_impl=ssd_impl)
        fused = [key for k, key in sorted(scope.sites.items())
                 if best_impl(k) in (None, "fused")]
    points = [p for p in map(tune_point, fused) if p]
    return list(dict.fromkeys(points + noted))


def dispatch_table(store: TuneStore | str | None = None,
                   machine: str | None = None) -> list[DispatchRecord]:
    """All stored dispatch winners (optionally one machine's), sorted."""
    st = _as_store(store) if store is not None else active_store()
    out = [DispatchRecord.from_dict(d)
           for d in st.dispatch_records().values()]
    if machine is not None:
        out = [r for r in out if r.machine == machine]
    out.sort(key=lambda r: (r.op, r.key))
    return out


def active_dispatch_table(machine: str = DEFAULT_MACHINE,
                          store: TuneStore | str | None = None
                          ) -> dict[str, dict[str, Any]]:
    """Per site: what the dispatch table held at stamp time (the record's
    ``meta.dispatch_table``)."""
    return {r.key: {"op": r.op, "impl": r.impl,
                    "fused_wall_s": r.fused_wall_s,
                    "ref_wall_s": r.ref_wall_s,
                    "git_sha": r.git_sha, "torch": r.torch_version,
                    "timestamp": r.timestamp}
            for r in dispatch_table(store, machine)}
