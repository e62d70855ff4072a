"""Collective microbenchmarks: the ERT discipline applied to the wire
(port of ``repro.net.collectives``).

Each benchmark times one collective (all-reduce, all-gather,
reduce-scatter, all-to-all) over the ranks of a real process group
across a sweep of message sizes, as ``repro_torch.kernels.ert`` times the
FMA chain and the triad across working-set sizes.  The *wire* bytes of
each sample use the ring formulas the op walk applies to the collectives
it counts (``core/op_analysis._COLL_MULT``: all-reduce ``2(n-1)/n``, the
others ``(n-1)/n``), so the measured ceiling and the attributed traffic
are in one unit.

Two legs, laid out as the reference's meshes:

* ``ici`` — the collective runs over every rank (one "pod");
* ``dcn`` — the ranks form a ``(2, n/2)`` ``("pod", "x")`` mesh and the
  collective runs over its ``"pod"`` dimension (groups of 2), the
  cross-pod leg ``distributed/compression.py`` shrinks.

On the host the ranks are gloo processes and both legs cross the same
loopback; across cards they are NCCL ranks, one a card.
"""

from __future__ import annotations

import time
import warnings
from typing import Any

#: benchmarked collectives, in report order
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
#: interconnect legs, fastest first (as ``MachineSpec.interconnect``)
LEGS = ("ici", "dcn")


def wire_bytes(op: str, payload_bytes: float, group_size: int) -> float:
    """Ring-algorithm wire bytes of one collective, with the op walk's
    ``max(group_size, 2)`` floor."""
    n = max(group_size, 2)
    if op == "all_reduce":
        return 2.0 * (n - 1) / n * payload_bytes
    if op in ("all_gather", "reduce_scatter", "all_to_all"):
        return (n - 1) / n * payload_bytes
    return float(payload_bytes)


def payload_bytes(op: str, elems_per_device: int, group_size: int,
                  itemsize: int = 4) -> float:
    """Payload of one collective, in the op walk's convention: the result
    of an all-reduce, the n× output of an all-gather, the larger (input)
    side of a reduce-scatter or an all-to-all."""
    if op == "all_gather":
        return float(group_size * elems_per_device * itemsize)
    return float(elems_per_device * itemsize)


def leg_groups(legs: tuple[str, ...] = LEGS) -> dict[str, Any]:
    """{leg: process group} over the initialised default group: ``ici``
    the whole ring, ``dcn`` the ``"pod"`` dimension of a ``(2, n/2)``
    mesh.  Every rank must call this, with the same ``legs``: the meshes
    make their groups in one order on all of them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    out = {}
    for leg in legs:
        if leg == "dcn":
            if n % 2:
                raise ValueError(f"dcn leg needs an even device count, "
                                 f"got {n}")
            mesh = init_device_mesh(dev, (2, n // 2),
                                    mesh_dim_names=("pod", "x"))
            out[leg] = mesh.get_group("pod")
        elif leg == "ici":
            out[leg] = init_device_mesh(dev, (n,),
                                        mesh_dim_names=("x",)).get_group("x")
        else:
            raise ValueError(f"unknown leg {leg!r}; valid: {LEGS}")
    return out


def run_op(op: str, x, group):
    """One collective of ``x`` over ``group`` (fp32, ``x.numel()``
    elements a rank), its result a new tensor."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    with warnings.catch_warnings():
        # newer torch renames the tensor collectives (*_single); the
        # older one the card's host runs has only these names
        warnings.simplefilter("ignore", FutureWarning)
        if op == "all_reduce":
            out = x.clone()
            dist.all_reduce(out, group=group)
        elif op == "all_gather":
            out = x.new_empty(n * x.numel())
            dist.all_gather_into_tensor(out, x, group=group)
        elif op == "reduce_scatter":
            out = x.new_empty(x.numel() // n)
            dist.reduce_scatter_tensor(out, x, group=group)
        elif op == "all_to_all":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
        else:
            raise ValueError(f"unknown collective {op!r}; valid: {OPS}")
    return out


def measure_collectives(sizes: tuple[int, ...], iters: int = 3,
                        warmup: int = 1, legs: tuple[str, ...] = LEGS
                        ) -> list[dict[str, Any]]:
    """Time every (leg × op × size) sample on this rank of the
    initialised default group (every rank calls it with the same
    arguments; the legs' groups are :func:`leg_groups`').

    ``sizes`` are fp32 elements a rank; a size that the group's size does
    not divide is skipped.  Each sample starts after a barrier and ends
    after its result is on the device (``torch.cuda.synchronize``); its
    time is the slowest rank's (an all-reduce MAX after the timed
    region), and a row keeps the least over ``iters`` samples.  Returns
    one row a sample: ``{leg, op, group_size, elems, payload_bytes,
    wire_bytes, t_s}``, the same on every rank."""
    import torch
    import torch.distributed as dist

    cuda = dist.get_backend() == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    groups = leg_groups(legs)
    rows: list[dict[str, Any]] = []
    for leg in legs:
        group = groups[leg]
        gsize = dist.get_world_size(group)
        for op in OPS:
            for elems in sizes:
                if elems % max(gsize, 1):
                    continue
                x = torch.ones(elems, dtype=torch.float32, device=dev)
                for _ in range(max(warmup, 1)):
                    run_op(op, x, group)
                sync()
                walls = []
                for _ in range(max(iters, 1)):
                    dist.barrier()
                    t0 = time.perf_counter()
                    run_op(op, x, group)
                    sync()
                    walls.append(time.perf_counter() - t0)
                slowest = torch.tensor(walls, dtype=torch.float64,
                                       device=dev)
                dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
                pay = payload_bytes(op, elems, gsize)
                rows.append({
                    "leg": leg, "op": op, "group_size": gsize,
                    "elems": elems, "payload_bytes": pay,
                    "wire_bytes": wire_bytes(op, pay, gsize),
                    "t_s": float(slowest.min()),
                })
    return rows


def fit_ceiling(samples: list[tuple[float, float]]
                ) -> tuple[float, float]:
    """(bytes_per_s, latency_s) from (wire_bytes, seconds) samples.

    Least-squares fit of ``t = latency + wire / bw`` (the alpha-beta
    collective model).  A degenerate fit (noise giving a non-positive
    slope) falls back to the best observed throughput with zero latency,
    so the stored ceiling is never nonsense."""
    if not samples:
        raise ValueError("no samples to fit")
    n = len(samples)
    sx = sum(w for w, _ in samples)
    sy = sum(t for _, t in samples)
    sxx = sum(w * w for w, _ in samples)
    sxy = sum(w * t for w, t in samples)
    denom = n * sxx - sx * sx
    slope = (n * sxy - sx * sy) / denom if denom else 0.0
    intercept = (sy - slope * sx) / n
    if slope <= 0:
        return max(w / t for w, t in samples if t > 0), 0.0
    return 1.0 / slope, max(intercept, 0.0)
