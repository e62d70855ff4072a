"""Interconnect characterization: measured collective ceilings into the
tune store (port of ``repro.net.characterize``).

The driver half of the net level.  The worker half
(``repro_torch.net.collectives``) times collectives on the ranks of a
real process group; this module starts those ranks
(``repro_torch.distributed.ranks``) — gloo ranks on 127.0.0.1 for the
``cpu-host`` key, one NCCL rank a card for a GPU key —, fits the
alpha-beta model per (leg, op), and stores the ceilings under the
machine key in the tune store, beside the kernel ceilings, in the
reference's records (either package reads the other's ``tune.json``):

* one record per (leg, op): ``kernel="net_<leg>_<op>"``, shape
  ``[n_devices]`` — the raw evidence;
* one summary record per leg: ``kernel="net_ici"`` / ``"net_dcn"``,
  shape ``[0]`` (the "any shape" sentinel of the ERT ceiling records) —
  what :func:`machine_with_net` folds into a
  :class:`~repro_torch.core.machine.MachineSpec`.

A second characterization of the same machine key is a store hit that
times nothing unless ``force=True``.  A GPU key needs as many cards as
ranks: with fewer it raises before starting any rank, naming both counts,
and stores nothing; it never measures gloo in NCCL's place.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.net.collectives import LEGS, measure_collectives

#: backend tag net records carry in their tune keys
NET_BACKEND = "collective"
#: dtype every collective sample uses (fp32 payloads)
NET_DTYPE = "float32"
#: shape sentinel of the per-leg summary records ("any shape")
SUMMARY_SHAPE = (0,)

#: fp32 elements a rank per sample (divisible by ring sizes 2..8)
DEFAULT_SIZES = (1024, 8192, 65536, 262144)
SMOKE_SIZES = (1024, 16384, 131072)
DEFAULT_DEVICES = 8
#: the machine key measured on the host's CPU (gloo ranks)
HOST_KEY = "cpu-host"


def summary_key(leg: str, machine: str) -> str:
    from repro_torch.tune.store import tune_key
    return tune_key(f"net_{leg}", SUMMARY_SHAPE, NET_DTYPE, machine,
                    backend=NET_BACKEND)


def net_ceilings(machine: Any, store: Any = None
                 ) -> dict[str, dict[str, Any]] | None:
    """Stored empirical interconnect ceilings of one machine key.

    ``{"ici": {bytes_per_s, latency_s, n_devices, key, timestamp,
    git_sha}, "dcn": {...}}``, or ``None`` when either leg is missing
    (consumers fall back to the datasheet, as an untuned kernel falls
    back to its default config)."""
    from repro_torch.tune.store import _as_store
    name = machine if isinstance(machine, str) else machine.name
    store = _as_store(store)
    out: dict[str, dict[str, Any]] = {}
    for leg in LEGS:
        rec = store.get(summary_key(leg, name))
        if rec is None:
            return None
        out[leg] = {
            "bytes_per_s": float(rec.params.get("bytes_per_s", rec.metric)),
            "latency_s": float(rec.params.get("latency_s", 0.0)),
            "n_devices": int(rec.params.get("n_devices", 0)),
            "key": rec.key,
            "timestamp": rec.timestamp,
            "git_sha": rec.git_sha,
        }
    return out


def machine_with_net(machine: Any, store: Any = None):
    """The machine spec with its stored net ceilings folded in when the
    store has both legs, the datasheet interconnect otherwise — never a
    mix of legs.  The one rule every bound shares (the sweep engine,
    ``Session.record``)."""
    from repro_torch.core.machine import get_machine
    spec = get_machine(machine) if isinstance(machine, str) else machine
    ceil = net_ceilings(spec.name, store)
    if not ceil:
        return spec
    return spec.with_empirical_net(
        {leg: c["bytes_per_s"] for leg, c in ceil.items()},
        {leg: c["latency_s"] for leg, c in ceil.items()})


# --------------------------------------------------------------------------
# measurement driver
# --------------------------------------------------------------------------

def backend_for(machine: str) -> str:
    """``gloo`` for the host's key, ``nccl`` for every card's."""
    return "gloo" if machine == HOST_KEY else "nccl"


def check_cards(machine: str, n_devices: int) -> None:
    """Raise unless this host has ``n_devices`` cards for a GPU key
    (``nccl`` puts one rank on each card and never two on one)."""
    if backend_for(machine) != "nccl":
        return
    import torch
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(
            f"net characterize on {machine} needs {n_devices} cards; this "
            f"host has {have} (one NCCL rank a card; no gloo figure is "
            f"stored in its place)")


def rank_job(rank: int, world: int, payload: Mapping[str, Any]) -> list:
    """One rank's share (``repro_torch.distributed.ranks`` target)."""
    return measure_collectives(tuple(payload["sizes"]),
                               iters=payload["iters"],
                               warmup=payload["warmup"])


def measure_on_ranks(n_devices: int, sizes: tuple, iters: int, warmup: int,
                     backend: str, timeout_s: float) -> list:
    """The rows of :func:`measure_collectives` from ``n_devices`` ranks
    started here (picklable, module scope: a pool worker's entry)."""
    from repro_torch.distributed.ranks import launch
    return launch("repro_torch.net.characterize:rank_job",
                  {"sizes": list(sizes), "iters": iters, "warmup": warmup},
                  n_devices, backend=backend, timeout_s=timeout_s)


def _measure_job(n_devices: int, sizes: tuple, iters: int, warmup: int,
                 backend: str, timeout_s: float) -> dict:
    """Supervised worker entry: measure, return rows or the error."""
    import traceback
    try:
        return {"rows": measure_on_ranks(n_devices, sizes, iters, warmup,
                                         backend, timeout_s)}
    except Exception:
        return {"error": traceback.format_exc()}


def _datasheet_bw(machine: str) -> dict[str, float]:
    from repro_torch.core.machine import MACHINES
    spec = MACHINES.get(machine)
    if spec is None:
        return {}
    return {lv.name: lv.bytes_per_s for lv in spec.interconnect}


def _fit_rows(rows: list[Mapping[str, Any]]
              ) -> dict[tuple[str, str], dict[str, Any]]:
    """(leg, op) → fitted ceiling and the samples behind it."""
    from repro_torch.net.collectives import fit_ceiling
    grouped: dict[tuple[str, str], list[Mapping[str, Any]]] = {}
    for r in rows:
        grouped.setdefault((r["leg"], r["op"]), []).append(r)
    out: dict[tuple[str, str], dict[str, Any]] = {}
    for key, rs in grouped.items():
        bw, lat = fit_ceiling([(r["wire_bytes"], r["t_s"]) for r in rs])
        out[key] = {"bytes_per_s": bw, "latency_s": lat,
                    "group_size": int(rs[0]["group_size"]),
                    "n_samples": len(rs),
                    "wall_s": max(float(r["t_s"]) for r in rs)}
    return out


def _persist(fits: Mapping[tuple[str, str], Mapping[str, Any]],
             machine: str, n_devices: int, sizes: tuple,
             store: Any) -> dict[str, dict[str, Any]]:
    """Per-op and per-leg summary records into the tune store (one atomic
    write); returns the fresh :func:`net_ceilings` view."""
    from repro_torch.tune.store import make_record
    datasheet = _datasheet_bw(machine)
    recs = {}
    per_leg: dict[str, dict[str, Any]] = {}
    for (leg, op), fit in sorted(fits.items()):
        rec = make_record(
            kernel=f"net_{leg}_{op}", shape=(n_devices,), dtype=NET_DTYPE,
            machine=machine, backend=NET_BACKEND,
            params={"leg": leg, "op": op,
                    "bytes_per_s": fit["bytes_per_s"],
                    "latency_s": fit["latency_s"],
                    "group_size": fit["group_size"],
                    "sizes": [int(s) for s in sizes]},
            wall_s=fit["wall_s"], metric=fit["bytes_per_s"],
            metric_name="wire_bytes_per_s", default_wall_s=0.0,
            default_metric=datasheet.get(leg, 0.0),
            n_candidates=fit["n_samples"])
        recs[rec.key] = rec.to_dict()
        per_leg.setdefault(leg, {})[op] = {
            "bytes_per_s": fit["bytes_per_s"],
            "latency_s": fit["latency_s"]}
    for leg, ops in per_leg.items():
        # a leg's ceiling is the best throughput any collective reached
        # over it (ERT: roofs are attainable maxima), with the least
        # fitted latency: optimistic, so an attributed collective time
        # stays a lower bound
        bw = max(o["bytes_per_s"] for o in ops.values())
        lat = min(o["latency_s"] for o in ops.values())
        rec = make_record(
            kernel=f"net_{leg}", shape=SUMMARY_SHAPE, dtype=NET_DTYPE,
            machine=machine, backend=NET_BACKEND,
            params={"leg": leg, "bytes_per_s": bw, "latency_s": lat,
                    "n_devices": n_devices, "ops": ops,
                    "sizes": [int(s) for s in sizes]},
            wall_s=0.0, metric=bw, metric_name="wire_bytes_per_s",
            default_wall_s=0.0, default_metric=datasheet.get(leg, 0.0),
            n_candidates=len(ops))
        recs[rec.key] = rec.to_dict()
    store.put_many(recs)
    ceil = net_ceilings(machine, store)
    assert ceil is not None
    return ceil


def characterize_net(machine: Any = HOST_KEY, *,
                     n_devices: int = DEFAULT_DEVICES,
                     sizes: tuple | None = None,
                     iters: int = 3, warmup: int = 1,
                     store: Any = None, force: bool = False,
                     smoke: bool = False, deadline_s: float = 900.0,
                     inline: bool = False) -> dict[str, Any]:
    """Measure (or fetch) this host's interconnect ceilings.

    Returns ``{machine, n_devices, ceilings, ops, cached, store}``;
    ``cached=True`` means both leg summaries were stored under this
    machine key already and nothing was timed.  ``n_devices`` ranks
    (even: the dcn leg splits them into two pods) run as gloo processes
    on the host's CPU for ``cpu-host``, and as NCCL processes, one a
    card, for any other key.  By default they are started by one
    supervised pool worker killed at ``deadline_s`` (its ranks exit with
    it); ``inline=True`` starts them from this process.
    """
    from repro_torch.tune.store import _as_store
    name = machine if isinstance(machine, str) else machine.name
    store = _as_store(store)

    if not force:
        cached = net_ceilings(name, store)
        if cached is not None:
            return {"machine": name, "n_devices": n_devices,
                    "ceilings": cached, "ops": {}, "cached": True,
                    "store": store.path}

    if sizes is None:
        sizes = SMOKE_SIZES if smoke else DEFAULT_SIZES
    sizes = tuple(int(s) for s in sizes)
    if n_devices % 2:
        raise ValueError(f"n_devices must be even (the dcn leg splits the "
                         f"ring into two pods), got {n_devices}")
    check_cards(name, n_devices)
    backend = backend_for(name)

    if inline:
        rows = measure_on_ranks(n_devices, sizes, iters, warmup, backend,
                                deadline_s)
    else:
        from repro_torch.resilience.watchdog import SupervisedPool
        with SupervisedPool(_measure_job, 1, deadline_s=deadline_s) as pool:
            outcomes = pool.run(
                [("net", (n_devices, sizes, iters, warmup, backend,
                          deadline_s))])
        out = outcomes["net"]
        value = out.value if out.ok else None
        if value is None or value.get("error"):
            err = (value or {}).get("error") or out.error or out.kind
            raise RuntimeError(
                f"collective characterization failed ({out.kind}): {err}")
        rows = value["rows"]

    fits = _fit_rows(rows)
    ceilings = _persist(fits, name, n_devices, sizes, store)
    ops: dict[str, dict[str, Any]] = {}
    for (leg, op), fit in sorted(fits.items()):
        ops.setdefault(leg, {})[op] = {
            "bytes_per_s": fit["bytes_per_s"],
            "latency_s": fit["latency_s"]}
    return {"machine": name, "n_devices": n_devices, "ceilings": ceilings,
            "ops": ops, "cached": False, "store": store.path}
