"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module makes no process
group.  The production meshes are (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")``; this process is rank 0 of a
*fake* process group of 256 / 512 ranks (``torch.testing``'s ``fake``
backend, whose collectives move nothing), the counterpart of the
reference's 512 forced host devices.  The dry run walks rank 0's local
ops on meta tensors over it; every rank of a regular mesh walks the
same shapes.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake default process group of
    ``world_size`` ranks, replacing a fake group of another size.  A real
    (gloo / NCCL) default group is never replaced: that raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is already "
                "initialized; the dry run's meshes need a fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def release_fake_group() -> None:
    """Destroy the default process group if it is a fake one (a dry run's):
    nothing after it in the process sees a group it did not make."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over a fake group of as many ranks (tests,
    hillclimb variants, the dry run).  Its device type is ``cuda``, with
    no card needed: the dry run's tensors are meta tensors, and DTensor
    then plans its collectives as on GPUs (a CPU mesh would turn every
    all-to-all into an all-gather, gloo's fallback)."""
    fake_group(math.prod(shape))
    return init_device_mesh("cuda", tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The ranks the initialized process group has, as ``(n, 1)``
    ``("data", "model")``."""
    n = dist.get_world_size()
    return init_device_mesh(device_type, (n, 1),
                            mesh_dim_names=("data", "model"))


def merge_data_axes(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh with ``"pod"`` and ``"data"`` merged into one ``"data"``
    axis over the same ranks (pod-major), for the DTensors of a
    multi-pod cell; other meshes as they are.

    Every sharding rule shards the two together (``("pod", "data")``),
    so the merged axis gives the same placements and the same groups,
    while DTensor plans a dim sharded over two mesh dims — the batch
    after any reshape — with its graph-search redistribution planner,
    which takes minutes per op on a 3-D mesh of 512 ranks.  The specs
    are still computed on the three axes (``sharding.placements`` folds
    ``"pod"`` into the merged ``"data"``)."""
    names = mesh.mesh_dim_names or ()
    if "pod" not in names:
        return mesh
    if names != ("pod", "data", "model"):
        raise ValueError(f"cannot merge the data axes of {names}")
    ranks = mesh.mesh.reshape(-1, mesh.size(2))
    return DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("data", "model"))


def devices_per_pod(mesh: DeviceMesh) -> int:
    """Devices per pod (for the ICI/DCN split in collective analysis)."""
    names = mesh.mesh_dim_names or ()
    if "pod" in names:
        return mesh.size() // mesh.size(names.index("pod"))
    return mesh.size()
