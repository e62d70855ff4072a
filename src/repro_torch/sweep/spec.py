"""Declarative sweep specs: configs × meshes × AMP policies × batches ×
fusion modes (port of ``repro.sweep.spec``).

A :class:`SweepSpec` is the unit of a roofline *campaign* (the automated
batch workflow of arXiv 2009.02449): it names the axes of the cross
product, and :meth:`SweepSpec.expand` turns it into a work list of
:class:`SweepPoint`\\ s.  A point round-trips through JSON (the engine
ships it to a worker process and stamps it into the record's ``meta``)
and carries a content hash, :attr:`SweepPoint.key`, that keys the
analysis cache and groups a report's newest record per point.  The
points, keys and skips are the reference's for the same spec, so records
group the same way in either package's report.

The device a measured point runs on is not a point field (it would
change every key): the engine takes it as an argument and stamps it into
the record's ``meta``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Iterable, Mapping, Sequence

from repro_torch.configs.base import FUSION_MODES
from repro_torch.configs.registry import select_many

AMP_POLICIES = ("O0", "O1", "O2")

# the smoke preset: a CI-sized campaign (8 configs, minutes on a host)
SMOKE_CONFIGS = 8
SMOKE_SEQ = 16
SMOKE_BATCH = 2
SMOKE_ITERS = 2
SMOKE_WARMUP = 1


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One fully resolved cell of the campaign grid."""

    config: str                     # registry name
    seq: int
    batch: int                      # global batch (over the data axis)
    amp: str                        # O0 | O1 | O2
    mesh: tuple[int, int]           # (data, model) axis sizes; (1, 1) = none
    machine: str                    # MachineSpec name the bounds are against
    measured: bool                  # run and time, or bound-only analytical
    smoke: bool                     # smoke config variant vs full config
    fusion: str = "off"             # fused-kernel routing (FUSION_MODES)

    @property
    def n_devices(self) -> int:
        return self.mesh[0] * self.mesh[1]

    @property
    def label(self) -> str:
        """Human-readable point id (report rows, progress lines)."""
        mesh = f"m{self.mesh[0]}x{self.mesh[1]}"
        kind = "" if self.measured else "/analytical"
        fused = "" if self.fusion == "off" else f"/{self.fusion}"
        return (f"{self.config}/s{self.seq}b{self.batch}/{self.amp}/"
                f"{mesh}{fused}{kind}")

    @property
    def key(self) -> str:
        """Content hash: the cache key and the store's grouping key."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["mesh"] = list(self.mesh)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepPoint":
        kw = dict(d)
        kw["mesh"] = tuple(kw["mesh"])
        return cls(**kw)


def invalid_reason(point: SweepPoint) -> str | None:
    """Why a grid cell cannot run (``None``: it can).  A skip is logged
    with its reason, so a campaign's coverage is always accounted for."""
    if point.amp not in AMP_POLICIES:
        return f"unknown AMP policy {point.amp!r}"
    if point.fusion not in FUSION_MODES:
        return f"unknown fusion mode {point.fusion!r}"
    if point.mesh[0] < 1 or point.mesh[1] < 1:
        return f"bad mesh {point.mesh}"
    if point.batch % point.mesh[0]:
        return (f"global batch {point.batch} not divisible by "
                f"data axis {point.mesh[0]}")
    return None


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The declarative campaign: the axes of the cross product and the
    run policy."""

    name: str = "sweep"
    configs: tuple[str, ...] = ("all",)          # selectors (registry.select)
    seqs: tuple[int, ...] = (32,)
    batches: tuple[int, ...] = (4,)
    amps: tuple[str, ...] = ("O1",)
    fusions: tuple[str, ...] = ("off",)
    meshes: tuple[tuple[int, int], ...] = ((1, 1),)
    machine: str = "cpu-host"
    measure: bool = True
    smoke: bool = True                            # smoke config variants
    iters: int = 3
    warmup: int = 1

    def expand(self) -> tuple[list[SweepPoint], list[tuple[SweepPoint, str]]]:
        """(runnable points, skipped (point, reason)): the work list, in
        a fixed order — configs outermost (a campaign cut short still
        covers whole configs), then seq × batch × amp × fusion × mesh."""
        points: list[SweepPoint] = []
        skipped: list[tuple[SweepPoint, str]] = []
        for config in select_many(self.configs):
            for seq in self.seqs:
                for batch in self.batches:
                    for amp in self.amps:
                        for fusion in self.fusions:
                            for mesh in self.meshes:
                                p = SweepPoint(
                                    config=config, seq=seq, batch=batch,
                                    amp=amp, mesh=tuple(mesh),
                                    machine=self.machine,
                                    measured=self.measure, smoke=self.smoke,
                                    fusion=fusion)
                                reason = invalid_reason(p)
                                if reason is None:
                                    points.append(p)
                                else:
                                    skipped.append((p, reason))
        return points, skipped

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["meshes"] = [list(m) for m in self.meshes]
        return json.dumps(d, indent=2)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepSpec":
        kw = normalize_axes(dict(d))
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kw) - fields
        if unknown:
            raise ValueError(f"unknown sweep-spec keys {sorted(unknown)}; "
                             f"known: {sorted(fields)}")
        for tup in ("configs", "seqs", "batches", "amps", "fusions"):
            if tup in kw:
                kw[tup] = tuple(kw[tup])
        if "meshes" in kw:
            kw["meshes"] = tuple(tuple(m) for m in kw["meshes"])
        return cls(**kw)

    @classmethod
    def from_json(cls, text: str) -> "SweepSpec":
        return cls.from_dict(json.loads(text))


def normalize_axes(axes: dict[str, Any]) -> dict[str, Any]:
    """Resolve axis aliases in a spec dict (in place; also returned):
    ``mesh_shapes`` is the mesh-scale spelling of ``meshes``, each entry a
    ``(data, model)`` pair or a ``"DxM"`` string.  Both spellings at once
    is an error: preferring one would drop half the campaign."""
    if "mesh_shapes" in axes:
        if "meshes" in axes:
            raise ValueError("pass either meshes or mesh_shapes, not both")
        shapes = axes.pop("mesh_shapes")
        axes["meshes"] = tuple(
            parse_mesh(m) if isinstance(m, str) else tuple(m)
            for m in shapes)
    return axes


def parse_mesh(s: str) -> tuple[int, int]:
    """``"2x4"`` → (2, 4): (data, model) axis sizes."""
    parts = s.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh must be DxM (e.g. 1x1, 2x4), got {s!r}")
    return int(parts[0]), int(parts[1])


def parse_int_list(s: str | Iterable[int]) -> tuple[int, ...]:
    if isinstance(s, str):
        return tuple(int(x) for x in s.split(",") if x.strip())
    return tuple(int(x) for x in s)


def smoke_spec(n_configs: int = SMOKE_CONFIGS) -> SweepSpec:
    """The CI campaign: the first ``n_configs`` LM archs (in registry
    order they span the dense, hybrid, VLM, enc-dec, SSM and MoE
    families) at their smoke size, one device, measured."""
    from repro_torch.configs.registry import ARCHS
    return SweepSpec(
        name="smoke",
        configs=tuple(ARCHS[:max(1, n_configs)]),
        seqs=(SMOKE_SEQ,), batches=(SMOKE_BATCH,), amps=("O1",),
        meshes=((1, 1),), machine="cpu-host", measure=True, smoke=True,
        iters=SMOKE_ITERS, warmup=SMOKE_WARMUP)


def points_by_devices(points: Sequence[SweepPoint]
                      ) -> dict[int, list[SweepPoint]]:
    """The work list grouped by the devices a point needs: the engine
    runs one worker pool per group, each worker pinned to its group's
    cards."""
    out: dict[int, list[SweepPoint]] = {}
    for p in points:
        out.setdefault(p.n_devices, []).append(p)
    return dict(sorted(out.items()))
