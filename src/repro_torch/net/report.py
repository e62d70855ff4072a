"""Net reporting: stored interconnect ceilings and the mesh-scale ranking
(port of ``repro.net.report``).

Store-only, like every report here: the ceilings come from the tune
store (``repro_torch.net.characterize`` put them there) and the campaign
rows from stored sweep records; nothing is walked or timed again.  The
question it answers: *at what mesh shape does each config flip from
memory-bound to network-bound?*

Every stored phase payload carries the interconnect level
(``ici_bytes`` / ``dcn_bytes`` / ``ici_bound_s`` / ``dcn_bound_s``,
``repro_torch.trace.store.phase_payload``), so a point is
**network-bound** when its summed collective bound exceeds both its
memory and its compute bounds.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Sequence

from repro_torch.net.collectives import LEGS

#: the command that measures a machine key's ceilings
CHARACTERIZE_CMD = "python -m repro_torch net characterize"


def _unmeasurable_note(machine: str) -> str:
    """Why a GPU key cannot be measured on this host, or ``""``."""
    from repro_torch.net.characterize import backend_for
    if backend_for(machine) != "nccl":
        return ""
    import torch
    have = torch.cuda.device_count()
    if have >= 2:
        return ""
    return (f"; this host has {have} card(s), and NCCL needs one rank a "
            "card on 2 or more: no measurement is possible here")


def ceilings_text(machine: str = "cpu-host", store: Any = None) -> str:
    """The stored empirical ceilings with their provenance, or the
    datasheet note when this machine key was never characterized."""
    from repro_torch.net.characterize import net_ceilings
    ceil = net_ceilings(machine, store)
    lines = [f"interconnect ceilings (machine {machine}):"]
    if ceil is None:
        from repro_torch.core.machine import MACHINES
        spec = MACHINES.get(machine)
        if spec is None:
            return f"interconnect ceilings: unknown machine {machine!r}"
        note = _unmeasurable_note(machine)
        for lv in spec.interconnect:
            lines.append(f"  {lv.name:<4} {lv.bytes_per_s / 1e9:8.2f} GB/s"
                         f"  (datasheet — run `{CHARACTERIZE_CMD}` for "
                         f"measured roofs{note})")
        return "\n".join(lines)
    for leg in LEGS:
        c = ceil[leg]
        age = time.strftime("%Y-%m-%d", time.localtime(c["timestamp"]))
        lines.append(
            f"  {leg:<4} {c['bytes_per_s'] / 1e9:8.3f} GB/s  "
            f"lat {c['latency_s'] * 1e6:7.1f} us  "
            f"(measured, {c['n_devices']} device(s), {age}, "
            f"git {str(c['git_sha'])[:10]})")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# mesh-campaign rows
# --------------------------------------------------------------------------

def net_row(rec: Any) -> dict[str, Any]:
    """One record's phases folded into an interconnect summary row."""
    sums = {k: 0.0 for k in ("compute_s", "memory_s", "ici_s", "dcn_s",
                             "wall_s", "net_bytes")}
    for p in rec.phases.values():
        sums["compute_s"] += float(p.get("compute_s", 0.0))
        sums["memory_s"] += float(p.get("memory_s", 0.0))
        sums["ici_s"] += float(p.get("ici_bound_s", 0.0))
        sums["dcn_s"] += float(p.get("dcn_bound_s", 0.0))
        sums["wall_s"] += float(p.get("wall_s", 0.0))
        sums["net_bytes"] += float(p.get("net_bytes", 0.0))
    net_s = sums["ici_s"] + sums["dcn_s"]
    terms = {"compute": sums["compute_s"], "mem": sums["memory_s"],
             "net": net_s}
    mesh = dict(rec.mesh or {})
    n_devices = 1
    for v in mesh.values():
        n_devices *= max(int(v), 1)
    return {
        "config": rec.config,
        "label": str(rec.meta.get("label") or rec.config),
        "mesh": mesh,
        "n_devices": n_devices,
        "bound": max(terms, key=terms.get),
        "net_s": net_s,
        "step_bound_s": max(terms.values()),
        "net_frac": (net_s / max(terms.values())
                     if max(terms.values()) else 0.0),
        "run_id": rec.run_id,
        **sums,
    }


def net_rows(records: Sequence[Any] | Mapping[str, Any]
             ) -> list[dict[str, Any]]:
    """One row a point, configs together, smallest mesh first (the scale
    axis the flip detector walks)."""
    recs = list(records.values() if isinstance(records, Mapping)
                else records)
    rows = [net_row(r) for r in recs]
    rows.sort(key=lambda r: (r["config"], r["n_devices"],
                             sorted(r["mesh"].items())))
    return rows


def _mesh_label(mesh: Mapping[str, int]) -> str:
    if not mesh:
        return "1x1"
    return "x".join(str(mesh[k]) for k in sorted(mesh))


def flip_lines(rows: Sequence[Mapping[str, Any]]) -> list[str]:
    """For each config: where (if anywhere) along the mesh-scale axis the
    binding term flips to the network."""
    by_cfg: dict[str, list[Mapping[str, Any]]] = {}
    for r in rows:
        by_cfg.setdefault(r["config"], []).append(r)
    out: list[str] = []
    for cfg, rs in sorted(by_cfg.items()):
        flip = next((r for r in rs if r["bound"] == "net"), None)
        if flip is None:
            worst = max(rs, key=lambda r: r["net_frac"])
            out.append(
                f"{cfg}: never network-bound over the swept shapes "
                f"(closest: mesh {_mesh_label(worst['mesh'])} at "
                f"{worst['net_frac']:.0%} of its binding term)")
        elif flip is rs[0]:
            out.append(
                f"{cfg}: network-bound at every swept shape (already at "
                f"mesh {_mesh_label(flip['mesh'])}: net "
                f"{flip['net_s'] * 1e3:.3f}ms vs mem "
                f"{flip['memory_s'] * 1e3:.3f}ms)")
        else:
            prev = rs[rs.index(flip) - 1]
            out.append(
                f"{cfg}: flips {prev['bound']}-bound -> network-bound at "
                f"mesh {_mesh_label(flip['mesh'])} "
                f"(net {flip['net_s'] * 1e3:.3f}ms > mem "
                f"{flip['memory_s'] * 1e3:.3f}ms; at mesh "
                f"{_mesh_label(prev['mesh'])} it was "
                f"{prev['net_frac']:.0%})")
    return out


def render_net_report(records: Sequence[Any] | Mapping[str, Any],
                      machine: str = "cpu-host",
                      store: Any = None) -> str:
    """Ceilings, the ranked mesh-scale table and the flip lines."""
    parts = [ceilings_text(machine, store)]
    rows = net_rows(records)
    if not rows:
        parts.append("(no stored records with interconnect payloads — "
                     "run a sweep with mesh_shapes first)")
        return "\n\n".join(parts)
    ranked = sorted(rows, key=lambda r: r["step_bound_s"])
    header = (f"{'#':>2} {'point':<38}{'mesh':<8}{'dev':>4} "
              f"{'compute':>9} {'mem':>9} {'ici':>9} {'dcn':>9} "
              f"{'net%':>5}  bound")
    lines = [header]
    for i, r in enumerate(ranked, 1):
        lines.append(
            f"{i:>2} {r['label'][:37]:<38}"
            f"{_mesh_label(r['mesh']):<8}{r['n_devices']:>4} "
            f"{r['compute_s'] * 1e3:>8.3f}m {r['memory_s'] * 1e3:>8.3f}m "
            f"{r['ici_s'] * 1e3:>8.3f}m {r['dcn_s'] * 1e3:>8.3f}m "
            f"{r['net_frac']:>5.0%}  {r['bound']}")
    parts.append("mesh-scale ranking (best step bound first):\n"
                 + "\n".join(lines))
    parts.append("\n".join(flip_lines(rows)))
    return "\n\n".join(parts)
