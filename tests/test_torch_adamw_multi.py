"""The multi-tensor AdamW route against the JAX package.

The reference launches one fused AdamW kernel per leaf; the port updates
every leaf that routes to the kernel in one ``repro_torch::adamw_multi_``
call, which launches its CUDA kernel once per (g, m, v, p) dtype group.
On the CPU the call runs the plain version leaf by leaf, so this file
holds:

* ``adamw_update`` through the group route against
  ``repro.train.optim.adamw_update`` (the reference's plain math, which
  its fused kernel computes) at ``fusion="static"`` and ``"auto"`` (the
  dispatch table routing one leaf size to the plain chain), f32 and bf16
  state, in place and not, with leaves the kernel does not take (empty,
  a gradient of another shape) on the plain chain in both.  Tolerance
  as ``test_torch_train.py``'s AdamW test: two f32 ulps (2^-22) or two
  bf16 ulps (2^-7) of the leaf's largest value — the same fp32
  operations, XLA may fold a constant;
* the segment table as the pure function it is (``adamw.plan``): every
  element of every leaf covered once by the C entry's chunk layout and
  the kernel's chunk arithmetic (``_chunk_span``, written out from
  ``csrc/fused.cu``, whose constants the Python ones must equal),
  vectors only where all seven pointers sit on a vector boundary, the
  scalar head and tail, and the split at the table's capacity;
* the grouping by dtypes and the tune-store lookups it makes;
* the op walk's one record per group call, whose bytes and FLOPs are
  the sums of the one-leaf models (the reference's ``hbm_bytes`` plus
  the 8-byte ``bc`` a leaf), in place and not;
* the one walk over the four trees of ``adamw_update``.
"""

import bisect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused import adamw as r_adamw
from repro.train import optim as r_optim
from repro_torch import kernels
from repro_torch.configs.base import RunConfig
from repro_torch.core.op_analysis import analyze_fn
from repro_torch.kernels import build
from repro_torch.kernels.fused import adamw, ops
from repro_torch.train import optim as p_optim
from repro_torch.tune import dispatch as dsp

HYPER = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
# odd sizes, one at a chunk's edge; "e" is empty
SHAPES = {"a": (3, 7), "b": (4097,), "c": {"d": (5, 2, 3), "e": (0,)},
          "f": (4096,)}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _tree_np(rng, scale=1.0, positive=False, shapes=SHAPES):
    out = {}
    for k, s in shapes.items():
        if isinstance(s, dict):
            out[k] = _tree_np(rng, scale, positive, s)
        else:
            x = rng.standard_normal(s).astype(np.float32) * scale
            out[k] = np.abs(x) if positive else x
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _to_torch(tree, dtype):
    # a copy: jnp.asarray may wrap a numpy array without copying it and
    # read it after returning (asynchronous dispatch), so an update in
    # place must not write into the arrays the reference was given
    return jax.tree.map(lambda x: torch.from_numpy(x.copy()).to(dtype),
                        tree)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


# --------------------------------------------------------------------------
# adamw_update through the group route against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("fusion", ["static", "auto"])
def test_group_route_matches_reference(tmp_path, monkeypatch, fusion,
                                       inplace, dtype):
    """One update of a tree with odd sizes, an empty leaf and a gradient
    of another shape (broadcast against its leaf: ineligible, the plain
    chain in both packages).  Under ``auto`` the table's site of the
    21-element leaf prefers the plain chain, but the verdict is the dtype
    group's (the summed walls favour the kernel): every eligible leaf goes
    to the one group call, in leaf order."""
    rng = np.random.default_rng(11)
    p_np, g_np = _tree_np(rng), _tree_np(rng)
    m_np, v_np = _tree_np(rng, 0.1), _tree_np(rng, 0.01, positive=True)
    g_np["f"] = g_np["f"][:1]                   # (1,) against (4096,)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    r_p, r_s = r_optim.adamw_update(
        _to_jax(g_np, jnp.float32),
        r_optim.AdamWState(_to_jax(m_np, jdt), _to_jax(v_np, jdt),
                           jnp.asarray(4, jnp.int32)),
        _to_jax(p_np, jdt), lr=HYPER["lr"], run=None)

    seen = []
    real = adamw.fused_adamw_multi

    def spy(gs, ms, vs, ps, *args, **kw):
        seen.append([tuple(p.shape) for p in ps])
        return real(gs, ms, vs, ps, *args, **kw)

    monkeypatch.setattr(adamw, "fused_adamw_multi", spy)
    params = _to_torch(p_np, tdt)
    state = p_optim.AdamWState(_to_torch(m_np, tdt), _to_torch(v_np, tdt),
                               torch.tensor(4, dtype=torch.int32))
    grads = _to_torch(g_np, torch.float32)
    route = {"fused": 1e-3, "reference": 2e-3}

    def timer(impl, fn, args, iters, warmup):
        # the (3, 7) leaf's site: the plain chain wins
        flip = args[3].numel() == 21
        return route["reference" if flip and impl == "fused" else
                     "fused" if flip else impl]

    with dsp.dispatch_scope(store=str(tmp_path / "t.json"), mode="measure",
                            device="cpu", timer=timer):
        new_p, new_s = p_optim.adamw_update(
            grads, state, params, lr=HYPER["lr"],
            run=RunConfig(fusion=fusion), inplace=inplace)
    assert seen == [[(3, 7), (4097,), (5, 2, 3)]]
    assert (new_p["b"] is params["b"]) == inplace
    assert (new_s.mu["c"]["d"] is state.mu["c"]["d"]) == inplace
    assert int(new_s.count) == 5
    tol = 2.0 ** -22 if dtype == "float32" else 2.0 ** -7
    for name, got, want in (("p", new_p, r_p), ("m", new_s.mu, r_s.mu),
                            ("v", new_s.nu, r_s.nu)):
        for (path, g_leaf), (_, w_leaf) in zip(_leaves(got), _leaves(want)):
            w = _f32(w_leaf)
            assert g_leaf.dtype == tdt and g_leaf.shape == w.shape
            np.testing.assert_allclose(
                _f32(g_leaf), w, rtol=0,
                atol=tol * float(np.abs(w).max(initial=0.0)),
                err_msg=f"{name} {path}")


@pytest.mark.parametrize("case", ["near_tie", "group_loses", "two_groups"])
def test_auto_routes_each_dtype_group_whole(tmp_path, monkeypatch, case):
    """Under ``auto`` the AdamW verdict is the dtype group's, by the sums
    of its leaves' measured walls (the sites keep the reference's keys):

    * ``near_tie``: the 16,384-element leaf's site reads the plain chain
      1% faster (PR 20's run 9), the others the kernel 2x faster — the
      leaf stays in the group's one launch;
    * ``group_loses``: every site reads the chain faster — no launch;
    * ``two_groups``: an f32 group whose sites read the kernel faster and
      a bf16 group whose sites read the chain faster — one launch, of the
      f32 leaves.

    The update equals ``fusion="off"``'s within 1 ulp of the leaf dtype."""
    sizes = {"a": (4, 4000), "b": (16384,), "c": (3, 7), "d": (2, 2, 5)}
    dtypes = {k: torch.float32 for k in sizes}
    if case == "two_groups":
        dtypes.update(c=torch.bfloat16, d=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    mk = lambda s, dt, scale=1.0: (torch.randn(s, generator=gen) * scale
                                   ).to(dt)
    p0 = {k: mk(s, dtypes[k]) for k, s in sizes.items()}
    g0 = {k: mk(s, dtypes[k]) for k, s in sizes.items()}
    m0 = {k: mk(s, dtypes[k], 0.1) for k, s in sizes.items()}
    v0 = {k: mk(s, dtypes[k], 0.01).abs() for k, s in sizes.items()}

    def timer(impl, fn, args, iters, warmup):
        n, dt = args[3].numel(), args[3].dtype
        chain_wins = (case == "group_loses"
                      or (case == "two_groups" and dt == torch.bfloat16))
        if case == "near_tie" and n == 16384:
            return {"fused": 1.01e-3, "reference": 1e-3}[impl]
        if chain_wins:
            return {"fused": 2e-3, "reference": 1e-3}[impl]
        return {"fused": 1e-3, "reference": 2e-3}[impl]

    seen = []
    real = adamw.fused_adamw_multi

    def spy(gs, ms, vs, ps, *args, **kw):
        seen.append(sorted(tuple(p.shape) for p in ps))
        return real(gs, ms, vs, ps, *args, **kw)

    monkeypatch.setattr(adamw, "fused_adamw_multi", spy)
    clone = lambda t: {k: x.clone() for k, x in t.items()}
    state = p_optim.AdamWState(clone(m0), clone(v0),
                               torch.tensor(2, dtype=torch.int32))
    with dsp.dispatch_scope(store=str(tmp_path / "t.json"), mode="measure",
                            device="cpu", timer=timer):
        new_p, new_s = p_optim.adamw_update(
            g0, state, clone(p0), run=RunConfig(fusion="auto"))
    want = {"near_tie": [sorted(sizes.values())], "group_loses": [],
            "two_groups": [sorted([sizes["a"], sizes["b"]])]}[case]
    assert seen == want
    # every site keeps the reference's key, one record a leaf
    assert len(dsp.dispatch_table(str(tmp_path / "t.json"))) == len(sizes)
    off_p, off_s = p_optim.adamw_update(
        g0, p_optim.AdamWState(clone(m0), clone(v0),
                               torch.tensor(2, dtype=torch.int32)),
        clone(p0), run=RunConfig(fusion="off"))
    for got, ref in ((new_p, off_p), (new_s.mu, off_s.mu),
                     (new_s.nu, off_s.nu)):
        for k in sizes:
            ulp = 2.0 ** -22 if dtypes[k] == torch.float32 else 2.0 ** -7
            tol = ulp * float(ref[k].float().abs().max())
            assert float((got[k].float() - ref[k].float()).abs().max()) \
                <= tol, (case, k)


def test_update_without_fusion_calls_no_group(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "adamw_group",
                        lambda *a, **k: calls.append(a))
    rng = np.random.default_rng(3)
    params = _to_torch(_tree_np(rng), torch.float32)
    state = p_optim.adamw_init(params, RunConfig())
    p_optim.adamw_update(params, state, params, run=RunConfig(fusion="off"))
    p_optim.adamw_update(params, state, params, run=None)
    assert calls == []


# --------------------------------------------------------------------------
# The segment table
# --------------------------------------------------------------------------

def _constant(name: str) -> int:
    """The value of ``constexpr ... name = <int>;`` in ``csrc/fused.cu``."""
    src = (build.CSRC / "fused.cu").read_text()
    (value,) = re.findall(rf"constexpr [\w ]+ {name} = (\d+);", src)
    return int(value)


#: elements of a chunk, the unit a block takes
CHUNK = _constant("kAdamChunk")
#: int64 fields of a row of the table
FIELDS = _constant("kAdamFields")


def test_python_constants_are_the_kernels():
    """The wrapper's table holds the kernel's capacity, row width and mode
    bit, and its vector is the kernel's (``load4``/``store4``)."""
    src = (build.CSRC / "fused.cu").read_text()
    assert adamw.CAPACITY == _constant("kAdamSegs")
    assert adamw.VEC_MODE == _constant("kAdamVec")
    assert FIELDS == 9 and CHUNK % adamw.VEC == 0
    assert adamw.VEC == 4 and "(end - vlo) / 4 * 4" in src
    rows = adamw.plan([[64] * 7, [68] * 7], [5, 6], (4, 4, 4, 4))[0].rows
    assert rows == [64] * 7 + [5, adamw.VEC_MODE] + [68] * 7 + [
        6, adamw.VEC_MODE | 3]


def _first_chunks(rows: np.ndarray, chunk: int) -> list[int]:
    """Each leaf's first chunk and the total, as ``fused_adamw_multi`` in
    ``csrc/fused.cu`` lays them out: a leaf takes its head and ``chunk``
    elements more, then ``chunk`` a chunk, at least one chunk."""
    first = [0]
    for n, mode in rows[:, 7:9]:
        body = int(n) - (int(mode) & 3)
        first.append(first[-1] + (-(-body // chunk) if body > 0 else 1))
    return first


def _chunk_span(n: int, mode: int, j: int, chunk: int
                ) -> tuple[int, int, int, int]:
    """(lo, vlo, vhi, end) of chunk ``j`` of an ``n``-element leaf as
    ``adamw_kernel`` in ``csrc/fused.cu`` computes them: scalar [lo, vlo),
    vectors [vlo, vhi), scalar [vhi, end)."""
    head = mode & 3
    lo = head + j * chunk if j else 0
    end = min(n, head + (j + 1) * chunk)
    vlo = vhi = lo
    if mode & adamw.VEC_MODE:
        vlo = lo if j else min(head, end)
        vhi = vlo + (end - vlo) // adamw.VEC * adamw.VEC
    return lo, vlo, vhi, end


def _simulate(launch: adamw.Launch, chunk):
    """Walk the launch's chunks as the kernel does: the leaf by binary
    search over the first chunks, then the chunk's spans."""
    rows = np.asarray(launch.rows, dtype=np.int64).reshape(-1, FIELDS)
    first = _first_chunks(rows, chunk)
    spans = []
    for c in range(first[-1]):
        si = bisect.bisect_right(first, c) - 1
        n, mode = int(rows[si, 7]), int(rows[si, 8])
        spans.append((si, mode, _chunk_span(n, mode, c - first[si],
                                                 chunk)))
    return rows, spans


@pytest.mark.parametrize("chunk", [CHUNK, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_covers_every_element_once(chunk, seed):
    """Random lengths (1 up to several chunks, and chunk edges) and
    pointers: some leaves with all seven operands at one offset from a
    vector boundary, some at different offsets; f32 g with bf16 m, v, p
    and all-f32.  Every element of every leaf is in exactly one span;
    vector spans start on a boundary of every operand and hold whole
    vectors; scalar spans are the head (first chunk, < 4 elements) and
    the tail (< 4), except on a leaf whose offsets differ."""
    rng = np.random.default_rng(seed)
    for sizes in ((4, 4, 4, 4), (4, 2, 2, 2)):
        edges = [1, 3, 4, chunk - 1, chunk, chunk + 1, 2 * chunk + 5]
        numels = edges + list(rng.integers(1, 5 * chunk, 20))
        ptrs = []
        for i, _ in enumerate(numels):
            off = int(rng.integers(0, 4))
            shared = i % 3 != 2
            base = [int(rng.integers(1, 1 << 20)) * 64 for _ in range(7)]
            isz = (*sizes, sizes[3], sizes[1], sizes[2])
            ptrs.append([b + (off if shared else int(rng.integers(0, 4)))
                         * s for b, s in zip(base, isz)])
        launches = adamw.plan(ptrs, numels, sizes)
        assert len(launches) == 1 and launches[0].leaves == range(
            len(numels))
        rows, spans = _simulate(launches[0], chunk)
        assert list(rows[:, 7]) == numels
        covered = [np.zeros(n, dtype=np.int64) for n in numels]
        for si, mode, (lo, vlo, vhi, end) in spans:
            assert lo <= vlo <= vhi <= end <= numels[si]
            covered[si][lo:end] += 1
            if mode & adamw.VEC_MODE:
                assert (vhi - vlo) % adamw.VEC == 0
                assert vlo - lo < adamw.VEC and end - vhi < adamw.VEC
                for a, s in zip(rows[si, :7], isz):
                    assert vhi == vlo or (int(a) // s + vlo) % adamw.VEC == 0
            else:
                assert vlo == vhi == lo and mode == 0
        for c in covered:
            assert (c == 1).all()


def test_vector_head_flags():
    f32, bf16 = 4, 2
    assert adamw.vector_head([64] * 7, [f32] * 7) == 0
    assert adamw.vector_head([68] * 7, [f32] * 7) == 3
    assert adamw.vector_head([72] * 7, [f32] * 7) == 2
    assert adamw.vector_head([64, 68] + [64] * 5, [f32] * 7) is None
    # bf16's vector is 8 bytes: 8-byte alignment is a boundary
    assert adamw.vector_head([72] * 7, [bf16] * 7) == 0
    assert adamw.vector_head([74] * 7, [bf16] * 7) == 3
    # one element offset in both dtypes: a shared offset
    assert adamw.vector_head([68, 66, 66, 66, 66, 66, 66],
                             [f32, bf16, bf16, bf16, bf16, bf16, bf16]) == 3


@pytest.mark.parametrize("n_leaves,launches", [(1, [1]), (464, [464]),
                                               (465, [464, 1]),
                                               (1200, [464, 464, 272])])
def test_plan_splits_at_capacity(n_leaves, launches):
    numels = [(i % 7) + 1 for i in range(n_leaves)]
    ptrs = [[4096 * (i + 1)] * 7 for i in range(n_leaves)]
    out = adamw.plan(ptrs, numels, (4, 4, 4, 4))
    assert [len(x.leaves) for x in out] == launches
    assert [i for x in out for i in x.leaves] == list(range(n_leaves))
    for x in out:
        rows = np.asarray(x.rows).reshape(-1, FIELDS)
        assert list(rows[:, 7]) == [numels[i] for i in x.leaves]
        # one chunk a leaf: the grid the C entry may take
        assert _first_chunks(rows, CHUNK)[-1] == len(x.leaves)


def test_groups_and_their_lookups():
    f, b = torch.float32, torch.bfloat16
    t = lambda n, dt: torch.empty(n, dtype=dt)
    gs = [t(3, f), t(9, f), t(0, f), t(17, b), t(2, f)]
    ms = [t(3, f), t(9, b), t(0, f), t(17, b), t(2, f)]
    ps = [t(3, f), t(9, b), t(0, f), t(17, b), t(2, f)]
    assert adamw.groups(gs, ms, ms, ps) == {(f, f, f, f): [0, 2, 4],
                                            (f, b, b, b): [1],
                                            (b, b, b, b): [3]}
    # each group's size class: 5 -> 4, 9 -> 8, 17 -> 16
    assert adamw.tune_points(gs, ms, ms, ps) == [
        ("fused_adamw", (4,), "float32"), ("fused_adamw", (8,), "bfloat16"),
        ("fused_adamw", (16,), "bfloat16")]
    assert adamw.tune_points([gs[2]], [ms[2]], [ms[2]], [ps[2]]) == []


@pytest.mark.parametrize("n,shape", [(1, 1), (2, 2), (3, 2), (4096, 4096),
                                     (4097, 4096), (41_593_491, 1 << 25),
                                     (2_057_342_976, 1 << 30),
                                     (2_057_310_208, 1 << 30)])
def test_lookup_shape_is_the_size_class(n, shape):
    """The power of two at or below the group's element count.  The last
    two are glm4-9b's 4-layer AdamW group with every leaf routed to the
    kernel and with the 16,384-element leaf, whose dispatch verdict is a
    near tie, on the plain chain: one tuned record serves both."""
    assert adamw.lookup_shape(n) == (shape,)


# --------------------------------------------------------------------------
# The wrapper on the host
# --------------------------------------------------------------------------

def test_multi_runs_the_plain_version_per_leaf_on_the_cpu():
    rng = np.random.default_rng(4)
    shapes = [(3,), (4, 5), (4097,)]
    mk = lambda s, k=1.0: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * k)
    gs = [mk(s) for s in shapes]
    ms = [mk(s, 0.1).to(torch.bfloat16) for s in shapes]
    vs = [mk(s, 0.01).abs().to(torch.bfloat16) for s in shapes]
    ps = [mk(s).to(torch.bfloat16) for s in shapes]
    bc = torch.tensor([0.1, 0.05])
    kernels.reset_launch_counts()
    outs = adamw.fused_adamw_multi(gs, ms, vs, ps, bc, **HYPER)
    for i, leaf in enumerate(zip(gs, ms, vs, ps)):
        want = adamw.adamw_ref(*leaf, bc, **HYPER)
        for k in range(3):
            assert torch.equal(outs[k][i], want[k])
        one = adamw.fused_adamw(*leaf, bc, **HYPER)
        assert all(torch.equal(a, w) for a, w in zip(one, want))
    same = adamw.fused_adamw_multi(gs, ms, vs, ps, bc, inplace=True, **HYPER)
    assert all(a is b for a, b in zip(same[0], ps))
    assert all(torch.equal(a, b) for a, b in zip(ps, outs[0]))
    assert kernels.launch_counts()["fused_adamw"] == 0


def test_multi_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4)
    bc = torch.tensor([0.1, 0.05])
    with pytest.raises(ValueError, match="differ in length"):
        adamw.fused_adamw_multi([x, x], [x], [x], [x], bc)
    with pytest.raises(ValueError, match="shapes differ"):
        adamw.fused_adamw_multi([x], [x], [x[:2]], [x], bc)
    with pytest.raises(ValueError, match=r"\(2,\) float32"):
        adamw.fused_adamw_multi([x], [x], [x], [x], bc.double())
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        adamw.fused_adamw_multi([meta], [meta], [meta], [meta],
                                torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        adamw.fused_adamw_multi([x], [x], [x], [x],
                                torch.empty(2, device="meta"))


# --------------------------------------------------------------------------
# The op walk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("inplace", [True, False])
@pytest.mark.parametrize("dtypes", [("f32", "f32", "f32"),
                                    ("f32", "bf16", "bf16")])
def test_walk_holds_one_record_with_the_per_leaf_sums(dtypes, inplace):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    g_dt, m_dt, p_dt = (dt[d] for d in dtypes)
    shapes = [(4096, 3), (7,), (2, 2, 2), (151_552,)]
    gs = [torch.empty(s, dtype=g_dt) for s in shapes]
    ms = [torch.empty(s, dtype=m_dt) for s in shapes]
    ps = [torch.empty(s, dtype=p_dt) for s in shapes]

    def opt(*flat):
        k = len(shapes)
        ops.adamw_group(flat[:k], flat[k:2 * k], flat[k:2 * k],
                        flat[2 * k:], torch.empty(2), inplace=inplace,
                        **HYPER)

    (rec,) = analyze_fn(opt, (*gs, *ms, *ps)).kernels
    numels = [int(np.prod(s)) for s in shapes]
    isz = [t.itemsize for t in (g_dt, m_dt, p_dt)]
    assert rec.opcode == ("adamw_multi_" if inplace else "adamw_multi")
    assert rec.category == "custom"
    assert rec.exec_count == 1
    # each leaf as a one-leaf call: g, m, v, p in, p, m, v out, and bc
    assert rec.hbm_bytes == sum(
        n * (isz[0] + 2 * (2 * isz[1] + isz[2])) + 8 for n in numels)
    assert rec.flops == sum(adamw.flops(n) for n in numels) \
        == 16 * sum(numels)
    if dtypes == ("f32", "f32", "f32"):
        assert rec.hbm_bytes == sum(adamw.hbm_bytes(n) for n in numels) \
            == sum(r_adamw.hbm_bytes(n, 4) + 8 for n in numels)


# --------------------------------------------------------------------------
# The tree walk of adamw_update
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-1.3b", "deepcam"])
def test_walk_gives_tree_flatten_leaves(arch):
    """The one walk over params, grads, mu and nu gives each tree's
    ``tree_flatten`` leaves, in its order, on the smoke models' trees
    (nested dicts; DeepCAM's lists)."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import api as M
    from repro_torch.models import params as P
    spec = M.build(get_smoke(arch)).spec
    trees = [P.init(spec, torch.Generator().manual_seed(s), device="meta")
             for s in range(4)]
    got = p_optim._leaves_like(*trees)
    for leaves, tree in zip(got, trees):
        want = tree_flatten(tree)[0]
        assert len(leaves) == len(want) > 0
        assert all(a is b for a, b in zip(leaves, want))


def test_walk_refuses_a_tree_unlike_the_params_or_of_other_nodes():
    from collections import namedtuple
    t = lambda: torch.zeros(2)
    params = {"a": t(), "b": [t(), {"c": t()}]}
    like = lambda: {"a": t(), "b": [t(), {"c": t()}]}
    for bad, name in (({"a": t(), "b": [t()]}, "grads"),
                      ({"a": t(), "b": [t(), {"d": t()}]}, "grads"),
                      ({"a": t(), "b": (t(), {"c": t()})}, "grads"),
                      ({"a": None, "b": [t(), {"c": t()}]}, "grads")):
        with pytest.raises(ValueError, match=f"{name} tree does not match"):
            p_optim._leaves_like(params, bad, like(), like())
    with pytest.raises(ValueError, match="nu tree does not match"):
        p_optim._leaves_like(params, like(), like(), {"a": t()})
    # a node that no params tree holds (a namedtuple, None) is refused,
    # in the params as in the others
    Pair = namedtuple("Pair", "x y")
    for node in (Pair(t(), t()), None):
        tree = lambda: {"a": t(), "b": node}
        with pytest.raises(ValueError, match="the params hold a"):
            p_optim._leaves_like(tree(), tree(), tree(), tree())
        state = p_optim.AdamWState(tree(), tree(), torch.tensor(0))
        with pytest.raises(ValueError, match="the params hold a"):
            p_optim.adamw_update(tree(), state, tree(), run=None)


def test_update_keeps_no_gradient_alive():
    """Nothing of the update holds the gradients once the caller drops
    them: the train step frees each step's gradients by reference count,
    and a reference cycle (a recursive closure over the walk's lists)
    would keep them until the collector runs — on the card, a step's
    worth of gradients more per step until memory runs out."""
    import gc
    import weakref
    params = {"a": torch.zeros(3),
              "b": [torch.zeros(2), {"c": torch.zeros(4)}]}
    grads = {"a": torch.ones(3), "b": [torch.ones(2), {"c": torch.ones(4)}]}
    state = p_optim.adamw_init(params, RunConfig())
    refs = [weakref.ref(g) for g in (grads["a"], grads["b"][1]["c"])]
    gc.disable()
    try:
        p_optim.adamw_update(grads, state, params,
                             run=RunConfig(fusion="static"), inplace=True)
        del grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
