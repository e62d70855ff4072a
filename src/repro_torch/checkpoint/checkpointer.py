"""Atomic, verified checkpoints (port of
``repro.checkpoint.checkpointer``).

The on-disk layout is the reference's, so either package reads what the
other wrote:

.. code-block:: text

    <dir>/
    ├── step_00000008/
    │   ├── arrays.npz        one .npy member per leaf, key = name with
    │   │                     "/" → "__"
    │   └── manifest.json     {"step", "metadata", "leaves": {name:
    │                         {"key", "dtype", "shape"}}, "digest"}
    └── latest                "step_00000008"

* **names** — a leaf's name is its path in the tree, as the reference's
  ``jax.tree_util.tree_flatten_with_path`` spells it: dict keys, list
  indices and named-tuple fields joined by ``/`` (``params/embed``,
  ``opt/mu/blocks/wq``, ``opt/count``, ``loss_scale/scale``, ``step``);
  ``None`` holds no leaf;
* **atomic commit** — files go to ``step_XXXXXXXX.tmp/``, one ``rename``
  publishes the directory, and ``latest`` is rewritten last;
* **verified** — the manifest's sha256 digest covers every leaf's name,
  dtype name, shape and bytes in name order; :func:`restore` recomputes
  it and raises :class:`CheckpointCorrupt` on a mismatch.  GC never
  deletes the directory ``latest`` points to;
* **async** — :class:`AsyncCheckpointer` copies the tree to host memory
  synchronously (the train step updates its tensors in place, so the
  copy must be taken before the next step) and writes on a thread;
  ``healthy()`` reports a failed write without blocking.

bfloat16 leaves: the card's Python has no ``ml_dtypes`` and numpy no
bfloat16 of its own.  Each ``.npy`` member is written and read here
directly (a header and the raw little-endian bytes), so a bf16 leaf
travels as its 16-bit words.  The port writes its header's ``descr`` as
``'bfloat16'``, the name numpy resolves once ``ml_dtypes`` is imported
(as it is wherever the reference runs), so the reference's ``np.load``
reads the leaf back as bfloat16 and its digest matches.  The reference
itself writes ``'<V2'`` (numpy's descr for ``ml_dtypes.bfloat16``); the
port reads a ``V2`` leaf whose manifest dtype is ``bfloat16`` as
bfloat16, so its digest matches too.

On a mesh (DTensor leaves) every rank takes part in the snapshot, which
gathers each leaf whole once; rank 0 alone writes, and every rank waits
for the commit (a barrier) before :func:`save` returns or
:meth:`AsyncCheckpointer.wait` does.  :func:`restore` with ``shardings=``
(a tree of ``sharding.NamedSharding`` like ``tree_like``) is the
reference's elastic re-shard: every rank reads each whole leaf and keeps
its shard, so a checkpoint saved on one mesh restores onto a mesh of
another shape.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.resilience import faults

_MANIFEST = "manifest.json"
_LATEST = "latest"
_ARRAYS = "arrays.npz"
_MAGIC = b"\x93NUMPY"

#: the dtype names the manifest and the digest use (numpy's), per torch
#: dtype
_NAMES = {torch.float64: "float64", torch.float32: "float32",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed its integrity check (digest mismatch)."""


# --------------------------------------------------------------------------
# Trees: named leaves in the reference's spelling
# --------------------------------------------------------------------------

def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a container node, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) of every leaf, in the reference's naming."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix or "root", tree)]
    out = []
    for k, v in kids:
        out.extend(_leaf_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(tree: Any, leaf_of, prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaf_of(name,
    leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return leaf_of(prefix or "root", tree)
    new = [_rebuild(v, leaf_of, f"{prefix}/{k}" if prefix else k)
           for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), new))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    return type(tree)(new)


def _host(leaf: Any) -> torch.Tensor:
    """A host copy of a leaf that later in-place updates do not reach (a
    DTensor leaf gathered whole)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.array(leaf, copy=True))
    if not isinstance(leaf, torch.Tensor):
        return torch.as_tensor(leaf)
    return leaf.detach().to("cpu", copy=True)


# --------------------------------------------------------------------------
# Leaves on disk: .npy members of one zip, written and read here
# --------------------------------------------------------------------------

def _raw(t: torch.Tensor) -> np.ndarray:
    """The C-order bytes of a host tensor, as a uint8 array (no copy when
    it is contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _descr(dtype_name: str) -> str:
    if dtype_name == "bfloat16":
        return "bfloat16"
    return np.lib.format.dtype_to_descr(np.dtype(dtype_name))


def _npy_header(descr: str, shape: tuple[int, ...]) -> bytes:
    """A version-1.0 ``.npy`` header, padded as numpy pads it."""
    d = (f"{{'descr': {descr!r}, 'fortran_order': False, "
         f"'shape': {tuple(shape)!r}, }}")
    pad = (64 - (len(_MAGIC) + 4 + len(d) + 1) % 64) % 64
    d = d + " " * pad + "\n"
    return _MAGIC + b"\x01\x00" + struct.pack("<H", len(d)) + d.encode(
        "latin1")


def _read_npy(f) -> tuple[str, tuple[int, ...], bytes]:
    """(descr, shape, raw bytes) of one C-order ``.npy`` member (both
    packages write C order)."""
    if f.read(6) != _MAGIC:
        raise ValueError("not a .npy member")
    major = f.read(2)[0]
    n = struct.unpack("<H" if major == 1 else "<I",
                      f.read(2 if major == 1 else 4))[0]
    hdr = ast.literal_eval(f.read(n).decode("latin1"))
    if hdr["fortran_order"]:
        raise ValueError("a Fortran-order leaf: neither package writes one")
    return hdr["descr"], tuple(hdr["shape"]), f.read()


def _dtype_name(descr: str, manifest_dtype: str) -> str:
    """The numpy dtype name of a stored leaf: ``'bfloat16'`` for the
    port's descr and for the reference's 2-byte void whose manifest says
    bfloat16, else numpy's name for the descr."""
    if descr == "bfloat16" or (descr in ("<V2", "|V2")
                               and manifest_dtype == "bfloat16"):
        return "bfloat16"
    dt = np.dtype(descr)
    if dt.byteorder == ">":
        raise ValueError(f"big-endian leaf {descr!r} is not supported")
    return dt.name


def _tensor(name: str, shape: tuple[int, ...], raw: bytes) -> torch.Tensor:
    dt = _DTYPES[name]
    if not raw:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
        dt).reshape(shape)


def _digest_update(h, name: str, dtype: str, shape: tuple, raw) -> None:
    h.update(name.encode())
    h.update(dtype.encode())
    h.update(repr(tuple(shape)).encode())
    h.update(raw)


def _tree_digest(named: list[tuple[str, str, tuple, Any]]) -> str:
    """sha256 over (name, dtype name, shape, bytes) of every leaf, in
    sorted name order — the reference's save-time fingerprint."""
    h = hashlib.sha256()
    for leaf in sorted(named, key=lambda t: t[0]):
        _digest_update(h, *leaf)
    return h.hexdigest()


# --------------------------------------------------------------------------
# Save
# --------------------------------------------------------------------------

def save(directory: str, step: int, tree: Any,
         metadata: dict | None = None, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the committed directory.
    ``keep`` bounds how many committed checkpoints GC retains (0 = never
    collect)."""
    host = _rebuild(tree, lambda _n, leaf: _host(leaf))
    mesh = _on_mesh(tree)
    path = os.path.join(directory, f"step_{step:08d}")
    if not mesh or _dist().get_rank() == 0:
        path = _write(directory, step, host, metadata or {}, keep)
    if mesh:
        _dist().barrier()
    return path


def _dist():
    import torch.distributed as dist
    return dist


def _on_mesh(tree: Any) -> bool:
    """Does ``tree`` hold DTensors of an initialized process group (whose
    ranks save and wait together)?"""
    return (any(is_dtensor(leaf) for _, leaf in _leaf_paths(tree))
            and _dist().is_initialized())


class AsyncCheckpointer:
    """Snapshot synchronously, write on a background thread.
    ``write_walls`` holds (step, seconds) of each completed write."""

    def __init__(self, keep: int = 3) -> None:
        self.keep = keep
        self.write_walls: list[tuple[int, float]] = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._mesh = False

    def save(self, directory: str, step: int, tree: Any,
             metadata: dict | None = None, keep: int | None = None) -> None:
        self.wait()                                       # one write in flight
        host = _rebuild(tree, lambda _n, leaf: _host(leaf))
        keep_n = self.keep if keep is None else keep
        self._mesh = _on_mesh(tree)
        if self._mesh and _dist().get_rank() != 0:
            return                        # rank 0 writes; wait() syncs

        def work():
            try:
                t0 = time.perf_counter()
                _write(directory, step, host, metadata or {}, keep_n)
                self.write_walls.append((step, time.perf_counter() - t0))
            except BaseException as e:                    # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def healthy(self) -> bool:
        """True while no background write has failed.  Non-blocking: the
        training loop polls this each log interval so a dead checkpointer
        fails the run promptly instead of at the *next* save attempt."""
        return self._error is None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh:
            self._mesh = False
            _dist().barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _write(directory: str, step: int, host_tree: Any, metadata: dict,
           keep: int = 3) -> str:
    faults.active_plan().maybe_raise("ckpt_fail", target=step,
                                     exc=faults.InjectedFault)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "metadata": metadata, "leaves": {}}
    named = []
    with zipfile.ZipFile(os.path.join(tmp, _ARRAYS), "w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, t in _leaf_paths(host_tree):
            dtype = _NAMES[t.dtype]
            shape = tuple(t.shape)
            raw = _raw(t)
            key = name.replace("/", "__")
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                f.write(_npy_header(_descr(dtype), shape))
                f.write(raw.data)
            named.append((name, dtype, shape, raw.data))
            manifest["leaves"][name] = {"key": key, "dtype": dtype,
                                        "shape": list(shape)}
    manifest["digest"] = _tree_digest(named)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                                  # atomic publish
    with open(os.path.join(directory, _LATEST + ".tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(directory, _LATEST + ".tmp"),
               os.path.join(directory, _LATEST))
    _gc(directory, keep=keep)
    return final


def _gc(directory: str, keep: int) -> None:
    """Collect old ``step_*`` dirs down to ``keep`` (0 disables GC).

    The directory ``latest`` points to is always protected, even when it
    is not among the newest ``keep``: a restore that resolved ``latest``
    a moment ago must still find its target on disk.
    """
    if keep <= 0:
        return
    try:
        with open(os.path.join(directory, _LATEST)) as f:
            pointed = f.read().strip()
    except OSError:
        pointed = ""
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        if d == pointed:
            continue
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


# --------------------------------------------------------------------------
# Restore
# --------------------------------------------------------------------------

def latest_step(directory: str) -> int | None:
    try:
        with open(os.path.join(directory, _LATEST)) as f:
            name = f.read().strip()
        return int(name.removeprefix("step_"))
    except (FileNotFoundError, ValueError):
        return None


def available_steps(directory: str) -> list[int]:
    """Committed checkpoint steps on disk, oldest first — the fallback
    ladder a restore walks when the newest checkpoint fails its digest."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for d in names:
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.removeprefix("step_")))
            except ValueError:
                continue
    return sorted(out)


def _resolve(directory: str, step: int | None) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    return os.path.join(directory, f"step_{step:08d}")


def leaf_names(directory: str, step: int | None = None) -> list[str]:
    """The leaf names a checkpoint holds (the newest by default)."""
    with open(os.path.join(_resolve(directory, step), _MANIFEST)) as f:
        return list(json.load(f)["leaves"])


def restore(directory: str, tree_like: Any, step: int | None = None,
            verify: bool = True, device: str | torch.device | None = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Load a checkpoint into the structure of ``tree_like``.

    Each leaf is cast to the dtype of its counterpart in ``tree_like`` and
    placed on ``device``, by default on that counterpart's device (the
    host where it is a ``meta`` tensor: a meta tree is the usual "shape
    only" template).  Only the leaves ``tree_like`` names are read, so a
    sub-tree template (a train state's ``params``, named with their
    prefix) loads only those.  ``verify`` recomputes the manifest digest
    over every stored leaf and raises :class:`CheckpointCorrupt` on a
    mismatch (manifests without the digest field pass unverified).
    ``shardings`` (a ``NamedSharding`` tree like ``tree_like``): each leaf
    becomes a DTensor on its sharding's mesh, this rank keeping its shard
    of the whole leaf it read.  Returns (tree, metadata).
    """
    src = _resolve(directory, step)
    with open(os.path.join(src, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = manifest["leaves"]
    wanted = {n for n, _ in _leaf_paths(tree_like)}
    verifying = verify and "digest" in manifest
    # the digest reads every stored leaf in name order; only the leaves
    # the template names are kept
    h = hashlib.sha256()
    loaded: dict[str, torch.Tensor] = {}
    with zipfile.ZipFile(os.path.join(src, _ARRAYS)) as zf:
        for name in sorted(leaves):
            if not verifying and name not in wanted:
                continue
            info = leaves[name]
            with zf.open(info["key"] + ".npy") as f:
                descr, shape, raw = _read_npy(f)
            dtype = _dtype_name(descr, info["dtype"])
            if verifying:
                _digest_update(h, name, dtype, shape, raw)
            if name in wanted:
                loaded[name] = _tensor(dtype, shape, raw)
    if verifying and h.hexdigest() != manifest["digest"]:
        raise CheckpointCorrupt(
            f"{src}: digest mismatch (manifest {manifest['digest'][:12]}…, "
            f"arrays {h.hexdigest()[:12]}…) — checkpoint rejected")

    def leaf_of(name: str, like: Any) -> torch.Tensor:
        if name not in loaded:
            raise KeyError(f"{src} holds no leaf {name!r}")
        dt = like.dtype if isinstance(like, torch.Tensor) else None
        if device is not None:
            dev = torch.device(device)
        elif isinstance(like, torch.Tensor) and like.device.type != "meta":
            dev = like.device
        else:
            dev = torch.device("cpu")
        t = loaded[name].to(device=dev, dtype=dt)
        if placed is None:
            return t
        from repro_torch.distributed.sharding import distribute
        return distribute(t, placed[name])

    placed = dict(_leaf_paths(shardings)) if shardings is not None else None
    return _rebuild(tree_like, leaf_of), manifest["metadata"]
