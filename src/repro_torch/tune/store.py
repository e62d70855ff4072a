"""Persistent best-config store of the kernel autotuner (port of
``repro.tune.store``).

One JSON document ``{schema_version, records: {key: record}, dispatch:
{key: record}}`` keyed by ``kernel|backend|shape|dtype|machine``, in the
reference's schema, so ``repro.tune.store.TuneStore`` reads a store the
port wrote and the other way round.  Writes are read-modify-write through
an atomic ``os.replace``; a corrupt file is never fatal, and a document
or record from a newer schema is skipped with a warning.

The default path is the port's workspace (``<root>/tune.json``,
:class:`repro_torch.session.workspace.Workspace`); it never falls back to
the reference's ``benchmarks/results/``.

Hot lookups (a kernel wrapper's config, a dispatch verdict) go through
:func:`lookup`, which memoizes per (store path, namespace, key): a
repeated lookup costs one dict access, no ``os.stat``.  Every write from
this process clears the memo; a store rewritten by another process
during a run is seen by the next process.  Which store and which
machine key they read is what the innermost :func:`bind` says
(:func:`active_store`, :func:`machine_for`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Any, Iterable, Mapping, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.config import KernelConfig, default_config

SCHEMA_VERSION = 1
NAMESPACES = ("records", "dispatch")

#: machine key of a lookup on the host with no machine bound
DEFAULT_MACHINE = "cpu-host"


def default_store_path() -> str:
    """``tune.json`` of the default workspace root."""
    from repro_torch.session.workspace import Workspace
    return Workspace().tune_path


def shape_key(shape: Sequence[int]) -> str:
    return "x".join(str(int(s)) for s in shape)


def tune_key(kernel: str, shape: Sequence[int], dtype: str,
             machine: str, backend: str = "cuda") -> str:
    return f"{kernel}|{backend}|{shape_key(shape)}|{dtype}|{machine}"


@dataclasses.dataclass
class TuneRecord:
    """The winner of one search: the unit of storage and lookup."""

    schema_version: int
    key: str
    kernel: str
    backend: str                  # "cuda" (the kernels) | "torch" (plain)
    shape: list[int]
    dtype: str
    machine: str
    params: dict[str, Any]        # winning KernelConfig params
    wall_s: float                 # winner's measured wall seconds/call
    metric: float                 # objective value (maximized)
    metric_name: str              # "flops_per_s" | "bytes_per_s" | ...
    default_wall_s: float         # the default config's wall (before/after)
    default_metric: float
    n_candidates: int
    timestamp: float
    git_sha: str
    host: dict[str, str]
    #: ``build.digest`` of the library that ran the kernel ("" for the
    #: ``torch`` backend): a record of another build is stale
    library: str = ""

    @property
    def speedup(self) -> float:
        """Tuned-over-default improvement on the objective (>1 = win)."""
        return self.metric / self.default_metric if self.default_metric \
            else 1.0

    def config(self) -> KernelConfig:
        """Winning params over the kernel's default config."""
        return default_config(self.kernel).replace(**self.params)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TuneRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for name, dflt in (("schema_version", 0), ("key", ""),
                           ("kernel", "?"), ("backend", "cuda"),
                           ("shape", []), ("dtype", "float32"),
                           ("machine", "cpu-host"), ("params", {}),
                           ("wall_s", 0.0), ("metric", 0.0),
                           ("metric_name", ""), ("default_wall_s", 0.0),
                           ("default_metric", 0.0), ("n_candidates", 0),
                           ("timestamp", 0.0), ("git_sha", "unknown"),
                           ("host", {})):
            kw.setdefault(name, dflt)
        return cls(**kw)


#: (path, namespace, key) -> raw record or None; cleared by every write
_MEMO: dict[tuple[str, str, str], dict[str, Any] | None] = {}


class TuneStore:
    """Point-lookup JSON store with two namespaces: ``records`` (kernel
    config winners) and ``dispatch`` (site-keyed fused-vs-reference
    winners, :mod:`repro_torch.tune.dispatch`).  Every write keeps the
    other namespace."""

    def __init__(self, path: str | None = None):
        self.path = path or default_store_path()
        self._cache: tuple[tuple[float, int],
                           dict[str, dict[str, Any]]] | None = None

    def __repr__(self) -> str:
        return f"TuneStore({self.path!r})"

    # -- read ------------------------------------------------------------
    def _load_doc(self) -> dict[str, dict[str, Any]]:
        """Both namespaces, non-dict records dropped, cached per (mtime,
        size)."""
        try:
            st = os.stat(self.path)
        except OSError:
            return {ns: {} for ns in NAMESPACES}
        stamp = (st.st_mtime, st.st_size)
        if self._cache and self._cache[0] == stamp:
            return self._cache[1]
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError("not a JSON object")
        except (OSError, ValueError):
            warnings.warn(f"{self.path}: corrupt tune store ignored")
            doc = {}
        if doc.get("schema_version", 0) > SCHEMA_VERSION:
            warnings.warn(
                f"{self.path}: schema {doc.get('schema_version')} > "
                f"{SCHEMA_VERSION} (written by newer code) — ignored")
            doc = {}
        clean = {}
        for ns in NAMESPACES:
            raw = doc.get(ns)
            clean[ns] = ({k: v for k, v in raw.items()
                          if isinstance(v, dict)}
                         if isinstance(raw, dict) else {})
        self._cache = (stamp, clean)
        return clean

    def _get(self, ns: str, key: str) -> dict[str, Any] | None:
        d = self._load_doc()[ns].get(key)
        if d is not None and d.get("schema_version", 0) > SCHEMA_VERSION:
            warnings.warn(f"{self.path}: {ns} entry {key!r} from a newer "
                          "schema — skipped")
            return None
        return d

    def get(self, key: str) -> TuneRecord | None:
        d = self._get("records", key)
        return TuneRecord.from_dict(d) if d is not None else None

    def records(self) -> list[TuneRecord]:
        out = [TuneRecord.from_dict(d)
               for d in self._load_doc()["records"].values()
               if d.get("schema_version", 0) <= SCHEMA_VERSION]
        out.sort(key=lambda r: (r.kernel, r.backend, r.key))
        return out

    def keys(self) -> Iterable[str]:
        return self._load_doc()["records"].keys()

    # -- dispatch namespace ----------------------------------------------
    def get_dispatch(self, key: str) -> dict[str, Any] | None:
        return self._get("dispatch", key)

    def dispatch_keys(self) -> Iterable[str]:
        return self._load_doc()["dispatch"].keys()

    def dispatch_records(self) -> dict[str, dict[str, Any]]:
        return {k: v for k, v in self._load_doc()["dispatch"].items()
                if v.get("schema_version", 0) <= SCHEMA_VERSION}

    def put_dispatch_many(self,
                          records: Mapping[str, Mapping[str, Any]]) -> None:
        self._write(dispatch=records)

    # -- write -----------------------------------------------------------
    def put(self, rec: TuneRecord) -> TuneRecord:
        self.put_many({rec.key: rec.to_dict()})
        return rec

    def put_many(self, records: Mapping[str, Mapping[str, Any]]) -> None:
        """Write several raw record dicts in one atomic replace."""
        self._write(records=records)

    def _write(self, records: Mapping[str, Mapping[str, Any]] = (),
               dispatch: Mapping[str, Mapping[str, Any]] = ()) -> None:
        current = self._load_doc()
        merged = {ns: dict(current[ns]) for ns in NAMESPACES}
        for ns, new in (("records", records), ("dispatch", dispatch)):
            merged[ns].update({k: dict(v) for k, v in dict(new).items()})
        doc = {"schema_version": SCHEMA_VERSION, **merged}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        self._cache = None
        _MEMO.clear()


def make_record(kernel: str, shape: Sequence[int], dtype: str, machine: str,
                backend: str, params: Mapping[str, Any], wall_s: float,
                metric: float, metric_name: str, default_wall_s: float,
                default_metric: float, n_candidates: int) -> TuneRecord:
    from repro_torch.trace.store import git_sha, host_fingerprint
    return TuneRecord(
        schema_version=SCHEMA_VERSION,
        key=tune_key(kernel, shape, dtype, machine, backend),
        kernel=kernel, backend=backend, shape=[int(s) for s in shape],
        dtype=dtype, machine=machine, params=dict(params),
        wall_s=wall_s, metric=metric, metric_name=metric_name,
        default_wall_s=default_wall_s, default_metric=default_metric,
        n_candidates=n_candidates, timestamp=time.time(),
        git_sha=git_sha(), host=host_fingerprint(),
        library=library_stamp(kernel, backend))


def library_stamp(kernel: str, backend: str) -> str:
    """The build a record of ``kernel`` on ``backend`` is measured with:
    the digest of the kernel's library on ``cuda``, ``""`` on the host."""
    return build.kernel_digest(kernel) if backend == "cuda" else ""


def current(rec: Mapping[str, Any]) -> bool:
    """Whether a stored record (its dict) was measured with this build of
    its kernel's library.  A record of another build (an edited kernel,
    other compiled tiles, a store written before records were stamped) is
    a miss: the launch lookups take the default and a search times
    again."""
    return rec.get("library", "") == library_stamp(
        rec.get("kernel", "?"), rec.get("backend", "cuda"))


# --------------------------------------------------------------------------
# The lookups every consumer routes through
# --------------------------------------------------------------------------

_STORES: dict[str, TuneStore] = {}


def _as_store(store: "TuneStore | str | None") -> TuneStore:
    """A path or ``None`` → one shared :class:`TuneStore` per path, so its
    parse cache survives between lookups."""
    if isinstance(store, TuneStore):
        return store
    path = os.path.abspath(store or default_store_path())
    if path not in _STORES:
        _STORES[path] = TuneStore(path)
    return _STORES[path]


def lookup(store: "TuneStore | str | None", ns: str,
           key: str) -> dict[str, Any] | None:
    """The raw entry ``key`` of namespace ``ns`` (``None`` on a miss),
    memoized until the next write from this process."""
    st = _as_store(store)
    mkey = (st.path, ns, key)
    try:
        return _MEMO[mkey]
    except KeyError:
        d = st._get(ns, key)
        _MEMO[mkey] = d
        return d


# --------------------------------------------------------------------------
# The binding every lookup reads: which store, under which machine key
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Binding:
    """What the innermost :func:`bind` set (``None``: unset)."""

    store: "TuneStore | str | None" = None
    machine: str | None = None
    device: torch.device | None = None


_BOUND = Binding()


def bound() -> Binding:
    return _BOUND


@contextlib.contextmanager
def bind(store: "TuneStore | str | None" = None, machine: str | None = None,
         device: "str | torch.device | None" = None):
    """Bind the store, the machine key and the measuring device of every
    lookup in the ``with`` body (a kernel wrapper's tuned config, a
    dispatch verdict); unset arguments inherit the enclosing binding's."""
    global _BOUND
    prev = _BOUND
    _BOUND = Binding(
        store=store if store is not None else prev.store,
        machine=machine or prev.machine,
        device=torch.device(device) if device is not None else prev.device)
    try:
        yield _BOUND
    finally:
        _BOUND = prev


_DEFAULT: dict[tuple[str | None, str], TuneStore] = {}


def active_store() -> TuneStore:
    """The bound store, else the default workspace's ``tune.json``
    (resolved once per working directory and ``REPRO_WORKSPACE``)."""
    if _BOUND.store is not None:
        return _as_store(_BOUND.store)
    where = (os.environ.get("REPRO_WORKSPACE"), os.getcwd())
    st = _DEFAULT.get(where)
    if st is None:
        st = _DEFAULT[where] = _as_store(default_store_path())
    return st


_CARDS: dict[int, str] = {}


def _card_machine(index: int) -> str:
    """Datasheet machine name of CUDA card ``index`` (its own name when no
    datasheet spec matches)."""
    if index not in _CARDS:
        from repro_torch.core.machine import datasheet_for
        name = torch.cuda.get_device_name(index)
        try:
            _CARDS[index] = datasheet_for(name).name
        except KeyError:
            _CARDS[index] = name
    return _CARDS[index]


def machine_for(device: torch.device | None = None) -> str:
    """Machine key of a lookup: the bound machine, else the card's
    datasheet name for a CUDA ``device`` (or the bound CUDA device), else
    :data:`DEFAULT_MACHINE`."""
    if _BOUND.machine:
        return _BOUND.machine
    for dev in (device, _BOUND.device):
        if dev is not None and dev.type == "cuda":
            return _card_machine(dev.index if dev.index is not None
                                 else torch.cuda.current_device())
    return DEFAULT_MACHINE


def config_source(kernel: str, shape: Sequence[int], dtype: str = "float32",
                  machine: str = "cpu-host", backend: str = "cuda",
                  store: TuneStore | str | None = None
                  ) -> tuple[str, KernelConfig]:
    """("tuned" | "default", config) for one kernel instance; a stored
    winner of another build (:func:`current`) is a miss."""
    d = lookup(store, "records",
               tune_key(kernel, shape, dtype, machine, backend))
    if d is not None and current(d):
        return "tuned", TuneRecord.from_dict(d).config()
    return "default", default_config(kernel)


def best_config(kernel: str, shape: Sequence[int], dtype: str = "float32",
                machine: str = "cpu-host", backend: str = "cuda",
                store: TuneStore | str | None = None) -> KernelConfig:
    """Tuned winner for (kernel, shape, dtype, machine, backend), or the
    default config on a miss (a missing store is a miss)."""
    return config_source(kernel, shape, dtype, machine, backend, store)[1]


def tuned_kernels(store: TuneStore | str | None = None,
                  machine: str | None = None) -> dict[str, list[TuneRecord]]:
    """kernel → its stored winners (optionally one machine's)."""
    out: dict[str, list[TuneRecord]] = {}
    for rec in _as_store(store).records():
        if machine is None or rec.machine == machine:
            out.setdefault(rec.kernel, []).append(rec)
    return out


def active_kernel_configs(machine: str = "cpu-host",
                          store: TuneStore | str | None = None,
                          kernels: Sequence[str] = ("flash_attention",
                                                    "ssd_scan",
                                                    "fused_norm",
                                                    "fused_swiglu",
                                                    "fused_adamw")
                          ) -> dict[str, dict[str, Any]]:
    """Per model kernel: what the tune store offered at stamp time —
    ``"tuned_available"`` with its stored ``entries`` (a winner serves a
    call only at its exact shape and dtype), or ``"default"`` with the
    default params (the reference's stamp, ``meta.kernel_configs``)."""
    tuned = tuned_kernels(store, machine)
    out: dict[str, dict[str, Any]] = {}
    for kernel in kernels:
        recs = tuned.get(kernel, [])
        if recs:
            out[kernel] = {
                "source": "tuned_available",
                "entries": [{"shape": r.shape, "dtype": r.dtype,
                             "params": r.params} for r in recs]}
        else:
            out[kernel] = {"source": "default",
                           "params": default_config(kernel).dict}
    return out
