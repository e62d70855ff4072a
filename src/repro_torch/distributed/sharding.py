"""Logical-axis sharding rules → DTensor placements (DP / FSDP / TP / SP /
EP); port of ``repro.distributed.sharding``.

Every parameter spec (:class:`repro_torch.models.params.P`) names its axes
with a logical vocabulary; this module maps logical → mesh axes under a
:class:`repro_torch.configs.base.RunConfig` policy, by the reference's
rules:

* **TP** (Megatron): ``heads / kv_heads / ffn / expert_ffn / ssm_inner /
  vocab`` → ``"model"``;
* **EP**: ``experts`` → ``"model"``;
* **DP**: the batch dim of inputs → ``("pod", "data")``;
* **FSDP** (ZeRO-3): each parameter's first *unsharded, divisible* dim
  also over the data axes (never ``layers``);
* **SP**: the activation sequence dim → ``"model"`` between blocks.

Divisibility guard: a rule applies only where the dim divides the mesh
axis; otherwise that dim is replicated (glm4's 2 KV heads on a 16-way
model axis stay whole while its 32 query heads shard).  Where no dim took
``"model"``, the contracting ``embed`` dim does (row parallelism), except
in a table whose first axis is ``vocab``.

**Two layers.**  The rules produce one plain value per tensor, a
:data:`Spec`: a tuple with one entry per leading dim — ``None``, a mesh
axis name, or a tuple of names — in the canonical form of the
reference's ``PartitionSpec`` (trailing ``None``\\ s trimmed where the
reference trims them, a one-name tuple written as the name).  The rules
read only the mesh's axis names and sizes, so ``mesh`` may be a
:class:`~torch.distributed.device_mesh.DeviceMesh` or a plain mapping
``{axis: size}``.  :func:`placements` turns a spec into DTensor
placements on a device mesh: a dim over two mesh axis names is one
``Shard(dim)`` on each of those mesh dims.  A :class:`NamedSharding`
holds a spec and its mesh, and :func:`with_sharding` and
:func:`distribute` attach a tree of them to meta or real tensors.

:func:`constrain` pins an activation's sharding by logical names inside
the models (a ``redistribute``); on a plain tensor, or a mesh of one
device, it returns its input.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Any, Iterator, Mapping

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.configs.base import RunConfig
from repro_torch.models.params import P, tree_map_specs

#: one tensor's sharding: per leading dim None, a mesh axis or a tuple of
#: them (the reference's ``PartitionSpec``, canonical form)
Spec = tuple

# logical axis → mesh axis under TP/EP
_TP_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "expert_ffn": "model",
    "ssm_inner": "model",
    "experts": "model",
}


def is_dtensor(x: Any) -> bool:
    """Is ``x`` a DTensor?  (False at no cost while nothing has imported
    ``torch.distributed.tensor``: then no DTensor exists.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@contextlib.contextmanager
def plain_as_replicated() -> Iterator[None]:
    """Plain tensors that meet DTensors (positions, masks, constants the
    code makes) count as replicated ones: torch's ``implicit_replication``,
    restoring the previous state on exit so that it nests.  The flag is
    part of the autograd engine's thread-local state, so a backward run
    on the device's thread sees it too."""
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


def mesh_shape(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mapping already."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(shape: Mapping[str, int], name: str | tuple[str, ...]) -> int:
    if isinstance(name, tuple):
        return math.prod(shape[n] for n in name)
    return shape[name]


def _canon(axes: tuple[str, ...]) -> str | tuple[str, ...] | None:
    """A tuple of mesh axes as ``PartitionSpec`` writes it: ``()`` →
    None, a one-name tuple → the name."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _trim(spec: list) -> Spec:
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _data_axes(shape: Mapping[str, int]) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in shape)


def logical_to_spec(p: P, mesh: Any, run: RunConfig) -> Spec:
    """Map one parameter spec's logical axes to a :data:`Spec`."""
    shape = mesh_shape(mesh)
    out: list[Any] = []
    used: set[str] = set()
    for dim, ax in zip(p.shape, p.axes):
        assign = None
        if run.tp and ax in _TP_RULES:
            m = _TP_RULES[ax]
            if m not in used and dim % _axis_size(shape, m) == 0:
                assign = m
                used.add(m)
        out.append(assign)
    # row-parallel fallback: no dim took the model axis (minitron's 24
    # heads on a 16-way axis) → the embed (contracting) dim takes it, a
    # local partial product and an all-reduce; never an embedding table
    # (first axis "vocab"), which is gathered by token id
    if (run.tp and "model" not in used and len(p.shape) > 1
            and p.axes[0] != "vocab"):
        for i, (dim, ax) in enumerate(zip(p.shape, p.axes)):
            if ax == "embed" and dim % _axis_size(shape, "model") == 0:
                out[i] = "model"
                used.add("model")
                break
    if run.fsdp and "data" in shape:
        daxes = _data_axes(shape)            # ("pod","data") on multi-pod
        dsize = _axis_size(shape, daxes)
        for i, (dim, ax) in enumerate(zip(p.shape, p.axes)):
            if out[i] is None and ax not in ("layers",) and dim % dsize == 0 \
                    and dim >= dsize:
                out[i] = daxes if len(daxes) > 1 else daxes[0]
                break
    return _trim(out)


def param_shardings(specs: Any, mesh: Any, run: RunConfig) -> Any:
    """:data:`Spec` tree matching a parameter spec tree."""
    return tree_map_specs(lambda p: logical_to_spec(p, mesh, run), specs)


def batch_spec(mesh: Any, run: RunConfig, rank: int = 2,
               batch_size: int | None = None) -> Spec:
    """Inputs (B, S, ...): B over DP axes, S over model iff SP."""
    shape = mesh_shape(mesh)
    b = _data_axes(shape)
    if b and batch_size is not None and batch_size % _axis_size(shape, b):
        b = ()
    s = "model" if run.sp else None
    return (_canon(b), s, *([None] * (rank - 2)))


def batch_sharding(mesh: Any, run: RunConfig, rank: int = 2) -> Spec:
    return batch_spec(mesh, run, rank)


def replicated(mesh: Any) -> Spec:
    return ()


def kv_cache_sharding(mesh: Any, run: RunConfig, n_kv_heads: int) -> Spec:
    """KV cache (L, B, S, K, hd): B over DP, K over model if divisible."""
    shape = mesh_shape(mesh)
    b = _data_axes(shape)
    k = "model" if (run.tp and n_kv_heads % _axis_size(shape, "model") == 0) \
        else None
    return (None, _canon(b), None, k, None)


def _map_leaves(fn, tree: Any) -> Any:
    """``fn`` over every tensor leaf of ``tree``."""
    flat, spec = tree_flatten(tree)
    return tree_unflatten([fn(x) for x in flat], spec)


def shard_batch_dim(tree: Any, mesh: Any, run: RunConfig,
                    batch_axis: int = 0) -> Any:
    """Spec tree for an arbitrary pytree of batched tensors."""
    shape = mesh_shape(mesh)

    def one(x):
        rank = x.dim()
        spec: list[Any] = [None] * rank
        b = _data_axes(shape)
        if (rank > batch_axis and b
                and x.shape[batch_axis] % _axis_size(shape, b) == 0):
            spec[batch_axis] = _canon(b)
        return tuple(spec)
    return _map_leaves(one, tree)


# --------------------------------------------------------------------------
# Derived shardings: optimizer state, decode state
# --------------------------------------------------------------------------

def _pad_spec(spec: Spec, rank: int) -> list:
    out = list(spec)
    return out + [None] * (rank - len(out))


def reduced_spec(param_spec: Spec, param_rank: int, dropped_dim: int) -> Spec:
    """Sharding of a rank-reduced moment (Adafactor vr/vc) from its param."""
    full = _pad_spec(param_spec, param_rank)
    del full[dropped_dim % param_rank]
    return _trim(full)


def opt_state_shardings(opt_state_abstract: Any, param_shardings_tree: Any,
                        mesh: Any) -> Any:
    """Specs for an optimizer-state named tuple (AdamW / Adafactor).

    A field whose tree has as many leaves as the parameter tree takes its
    parameters' specs leaf by leaf (AdamW's moments exactly; Adafactor's
    factored moments truncated to their rank, each mesh axis kept only
    where it still divides); anything else (counts, scalars) is
    replicated."""
    shape = mesh_shape(mesh)
    flat_params = tree_flatten(param_shardings_tree,
                               is_leaf=lambda s: isinstance(s, tuple))[0]

    def assign(state_tree):
        leaves, treedef = tree_flatten(state_tree)
        if len(leaves) == len(flat_params):
            out = []
            for leaf, pspec in zip(leaves, flat_params):
                rank = len(leaf.shape)
                spec = _pad_spec(pspec, max(rank, len(pspec)))[:rank]
                spec = [a if a is not None and leaf.shape[i] %
                        _axis_size(shape, a) == 0 else None
                        for i, a in enumerate(spec)]
                out.append(_trim(spec))
            return tree_unflatten(out, treedef)
        return tree_unflatten([() for _ in leaves], treedef)

    return type(opt_state_abstract)(*[
        assign(field) for field in opt_state_abstract])


def decode_state_shardings(state_abstract: Any, mesh: Any, run: RunConfig
                           ) -> Any:
    """Decode caches: batch over DP axes; heads / channels over model.

    By dimension: dim 1 is batch (dim 0 the stacked layer / site axis),
    and the first of dims 3, 2, 4, ... (KV heads before sequence, so the
    cache write at a dynamic position is not on a sharded dim) that the
    model axis divides takes it."""
    shape = mesh_shape(mesh)
    b = _data_axes(shape)
    msize = _axis_size(shape, "model") if "model" in shape else 0
    bspec = _canon(b)

    def one(x):
        rank = x.dim()
        if rank <= 1:                          # lengths / scalars
            spec: list[Any] = [None] * rank
            if rank == 1 and b and x.shape[0] % _axis_size(shape, b) == 0:
                spec[0] = bspec
            return tuple(spec)
        spec = [None] * rank
        if b and x.shape[1] % _axis_size(shape, b) == 0:
            spec[1] = bspec
        if run.tp and msize:
            cands = ([3, 2] + list(range(4, rank)) if rank >= 4
                     else list(range(2, rank)))
            for i in cands:
                if x.shape[i] % msize == 0 and x.shape[i] >= msize:
                    spec[i] = "model"
                    break
        return _trim(spec)

    return _map_leaves(one, state_abstract)


# --------------------------------------------------------------------------
# Specs → DTensor placements
# --------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on the DeviceMesh ``mesh``: each
    mesh dim a tensor dim names is ``Shard(that dim)``, every other
    ``Replicate()``; a mesh dim of one device replicates whatever the spec
    says (a shard of one is the whole, and DTensor's view rules refuse
    some ops on it).  ``"pod"`` on a mesh without it, beside ``"data"``,
    is folded into ``"data"`` (``launch.mesh.merge_data_axes``)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import sharding_rules
    sharding_rules.register()
    names = mesh.mesh_dim_names
    out: list = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a == "pod" and a not in names and "data" in names:
                continue
            if a is not None and mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :data:`Spec` on a DeviceMesh (the reference's ``NamedSharding``):
    what :func:`with_sharding`, :func:`distribute`, the trainer and
    ``checkpointer.restore(shardings=)`` take, one per tensor."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def named(spec_tree: Any, mesh) -> Any:
    """A :class:`NamedSharding` tree of a :data:`Spec` tree on ``mesh``."""
    flat, treedef = tree_flatten(spec_tree, is_leaf=_is_spec)
    return tree_unflatten([NamedSharding(mesh, sp) for sp in flat], treedef)


def _zip_shardings(fn, tree: Any, sharding_tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    shs = tree_flatten(sharding_tree)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(leaves)} tensors against {len(shs)} "
                         "shardings")
    return tree_unflatten([fn(t, sh) for t, sh in zip(leaves, shs)],
                          treedef)


def with_sharding(abstract_tree: Any, sharding_tree: Any) -> Any:
    """Meta DTensors of the abstract tree's shapes and dtypes under its
    :class:`NamedSharding` tree (the dry run's sharded input specs;
    nothing is allocated): each rank's local tensor is its shard's meta
    tensor."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        meta = torch.empty(t.shape, dtype=t.dtype, device="meta")
        return distribute_tensor(meta, sh.mesh, sh.placements,
                                 src_data_rank=None)
    return _zip_shardings(one, abstract_tree, sharding_tree)


def distribute(tree: Any, sharding_tree: Any) -> Any:
    """The tensors of ``tree`` as DTensors under its :class:`NamedSharding`
    tree: every rank holds the whole tensor and keeps its shard
    (``src_data_rank=None``: no communication); a DTensor leaf is
    gathered whole first."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, sh):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return distribute_tensor(t.detach(), sh.mesh, sh.placements,
                                 src_data_rank=None)
    return _zip_shardings(one, tree, sharding_tree)


def gather(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as its whole tensor (each gathered
    once); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


# --------------------------------------------------------------------------
# Activation constraints (logical axes, applied inside the model code)
# --------------------------------------------------------------------------

_ACT_RULES = {
    "batch": ("pod", "data"),     # intersected with the tensor's mesh
    "seq": "model",               # only under run.sp
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_inner": "model",
    None: None,
}


def activation_spec(shape: tuple[int, ...], mesh: Any, run: RunConfig,
                    *logical: str | None) -> Spec:
    """The :data:`Spec` :func:`constrain` pins for a tensor of ``shape``:
    a dim whose mesh axes are absent, taken already or do not divide it
    is replicated (``None``)."""
    mshape = mesh_shape(mesh)
    if len(logical) != len(shape):
        raise ValueError(f"{len(logical)} logical names for shape {shape}")
    spec: list[Any] = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        tgt = _ACT_RULES.get(name)
        if name == "seq" and not run.sp:
            tgt = None
        if isinstance(tgt, tuple):
            tgt = tuple(a for a in tgt if a in mshape and a not in used)
            tgt = tgt if tgt else None
        elif tgt is not None and (tgt not in mshape or tgt in used):
            tgt = None
        if tgt is not None:
            size = _axis_size(mshape, tgt)
            if size <= 1 or dim % size != 0:
                tgt = None
        if tgt is not None:
            used.update(tgt if isinstance(tgt, tuple) else (tgt,))
        spec.append(tgt)
    return tuple(spec)


def gather_for_use(w: torch.Tensor) -> torch.Tensor:
    """A weight about to be used, with its FSDP shards (over every mesh
    axis but ``"model"``) gathered and its tensor-parallel shard kept: the
    all-gather ZeRO-3 does before use, which XLA inserts for the
    reference.  Its backward reduce-scatters the gradient.  Without it
    DTensor may instead gather the activations across the data axis and
    all-reduce the whole product.  ``w`` itself when it is not a DTensor
    or has no such shard."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    want = [p if n == "model" else Replicate()
            for n, p in zip(names, w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """An activation (B, S, ...) about to enter a product against a
    weight, with a sequence shard (sequence parallelism) gathered: the
    all-gather Megatron's SP does before its column-parallel products.
    ``x`` itself when it is not a DTensor or its sequence is whole."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if p == Shard(1) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _WholeSeqGrad(torch.autograd.Function):
    """Identity forward; the backward gathers a sequence-sharded gradient
    (:func:`gather_seq`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_seq(g)


def whole_seq_grad(y: torch.Tensor) -> torch.Tensor:
    """A product's output whose gradient must reach the product's
    backward with its sequence whole: under sequence parallelism the
    gradient comes back sequence-sharded from the next constraint, and
    the product's backward flattens (batch, sequence) into one dim, which
    DTensor cannot do over a sharded sequence in every torch the port
    runs on.  ``y`` itself when it is not a DTensor."""
    return _WholeSeqGrad.apply(y) if is_dtensor(y) else y


def constrain(x: torch.Tensor, run: RunConfig, *logical: str | None
              ) -> torch.Tensor:
    """Pin an activation's sharding by logical axis names: ``x``
    redistributed to :func:`activation_spec`'s placements (unnamed mesh
    axes replicated, a pending partial sum reduced).  ``x`` itself when it
    is not a DTensor or its mesh is one device, as the reference's is a
    no-op outside a mesh."""
    if not is_dtensor(x) or x.device_mesh.size() == 1:
        return x
    mesh = x.device_mesh
    spec = activation_spec(tuple(x.shape), mesh, run, *logical)
    want = placements(spec, mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
