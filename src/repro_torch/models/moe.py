"""Top-k routed mixture-of-experts block (port of ``repro.models.moe``).

Dispatch is **grouped**: the batch dim is the group dim, and each group of
S tokens is routed on its own with a per-group capacity C.  Within a
group, dispatch is sort-based: the S·K (token, expert) choices are sorted
by expert and ranked inside their expert by a cumulative count, so no
(S, E) one-hot matrix is formed.  A choice ranked at C or past it
overflows: its slot is row E·C, which is cut off the expert buffer, and
the combine gathers zeros for it.

Shapes (per group of S tokens, capacity C = S·K/E·cf rounded up to 8):
  route:    (S, E) fp32 logits → top-k (S, K)
  dispatch: buf (B, E, C, D)
  combine:  gather back (S, K, D), gate-weight, sum over K → (S, D)

The reference ``vmap``s one group's function over the batch; here every
step carries the group dim.  Three places where a direct port differs:

* ``jnp.argsort`` is stable, ``torch.argsort`` is not by default: the
  sort runs with ``stable=True``, so inside an expert the choices keep
  token order and a full expert drops the latest tokens (in a serving
  prefill chunk, the padded tail behind the real prompt).
* ``jax.lax.top_k`` breaks ties towards the lower index; ``torch.topk``
  (``sorted=True``) returns the same order, but which of two exactly
  equal probabilities it keeps is not specified.  Ties need bit-equal
  softmax outputs, which random weights do not give.
* The combine: the reference scatter-adds the K gate-weighted rows of a
  token in sorted order, in the compute dtype.  The port gathers each
  token's K rows in its own (s, k) order and sums over K (``torch.sum``
  accumulates bf16 in fp32 and rounds once): deterministic, where
  ``index_add_`` on CUDA is atomic, and the same function up to the
  order of the K-term sum.

Every step runs on meta tensors (the op walk): the per-expert counts are
a ``scatter_add`` into zeros (``torch.bincount`` has no meta kernel), and
no step reads a value back to the host.

Under ``remat="dots"`` the router product is kept (a product against a
weight, :func:`layers.wdot`); the expert products ``becd,edf->becf`` are
not, as the reference's ``checkpoint_dots_with_no_batch_dims`` does not
keep them (``e`` is a batch dim there).

:class:`RoutingTape` is a check's hold on the routing: it records each
routing call's top-k experts and can make a second run take them, so two
lowerings of a MoE compare with the same discrete choices.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import constrain, is_dtensor
from repro_torch.models import layers as L
from repro_torch.models.params import P

Params = Any

#: the active :class:`RoutingTape`, or None (the default: no routing call
#: looks at it)
_TAPE = None


class RoutingTape:
    """Records the routing while active (``with tape:``): each
    :func:`_route_group` call appends ``{"probs", "experts"}`` — its
    fp32 router probabilities (..., S, E) and top-k experts (..., S, K) —
    to ``calls``, in call order.  With ``replay`` (another tape's
    ``calls``), the i-th call takes its top-k experts from the i-th
    recorded call instead of its own ``topk``, and its gates are its own
    probabilities at those experts; ranks, capacity drops and the aux
    loss then follow as usual.

    Near-equal router probabilities are common (random weights give
    nearly uniform ones), so two lowerings of the same function that
    round differently can pick different experts for a token at a
    near-tie, and their outputs then differ by more than rounding.
    Replaying one run's choices in the other leaves rounding alone
    between them."""

    def __init__(self, replay: list | None = None):
        self.replay = replay
        self.calls: list[dict] = []

    def __enter__(self) -> "RoutingTape":
        global _TAPE
        if _TAPE is not None:
            raise RuntimeError("a RoutingTape is already active")
        _TAPE = self
        return self

    def __exit__(self, *exc) -> None:
        global _TAPE
        _TAPE = None

    def _take(self, probs, gate_vals, expert_ids):
        if self.replay is not None:
            expert_ids = self.replay[len(self.calls)]["experts"]
            if expert_ids.shape != gate_vals.shape:
                raise ValueError(f"replayed call {len(self.calls)}: experts "
                                 f"{tuple(expert_ids.shape)}, this call "
                                 f"routes {tuple(gate_vals.shape)}")
            gate_vals = torch.gather(probs, -1, expert_ids)
        self.calls.append({"probs": probs, "experts": expert_ids})
        return gate_vals, expert_ids


def moe_spec(cfg: ModelConfig) -> Params:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    spec = {
        "router": P((D, E), ("embed", "experts"), "small_normal"),
        "w_gate": P((E, D, Fd), ("experts", "embed", "expert_ffn")),
        "w_up": P((E, D, Fd), ("experts", "embed", "expert_ffn")),
        "w_down": P((E, Fd, D), ("experts", "expert_ffn", "embed")),
    }
    if cfg.moe_shared_ff:
        spec["shared"] = L.mlp_spec(cfg, cfg.moe_shared_ff)
    return spec


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """The reference's expression: ``int(S·K/E·cf)`` (a float product,
    truncated), rounded up to a multiple of 8, at least 8."""
    cap = int(tokens_per_group * cfg.experts_per_token / cfg.n_experts
              * cfg.capacity_factor)
    return max(8, (cap + 7) // 8 * 8)


def _route_group(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
                 capacity: int):
    """Route groups of tokens.  xg (..., S, D) fp32 → (slot, token, gate)
    (..., S·K) in sorted order, the aux loss terms ``me``, ``ce`` (..., E)
    and the sort's permutation ``order`` (..., S·K): sorted position i
    holds choice ``order[i]`` = s·K + k.  The leading dims are groups,
    each routed alone.  The first five are the reference's results.

    ``slot`` is ``expert·C + rank`` for a kept choice and ``E·C`` for an
    overflow, whose gate is 0."""
    S = xg.shape[-2]
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = L.wdot("...sd,de->...se", xg, router)             # (..., S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1, sorted=True)
    if _TAPE is not None:
        gate_vals, expert_ids = _TAPE._take(probs, gate_vals, expert_ids)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # load-balance aux loss terms (Switch eq. 4), averaged over groups later
    experts = torch.arange(E, device=xg.device)
    me = torch.mean(probs, dim=-2)                             # (..., E)
    ce = torch.mean((expert_ids[..., 0, None] == experts).float(), dim=-2)

    flat_e = expert_ids.flatten(-2)                            # (..., S*K)
    flat_t = torch.arange(S, device=xg.device).repeat_interleave(K)
    flat_g = gate_vals.flatten(-2)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = flat_t[order]
    sg = torch.gather(flat_g, -1, order)
    counts = torch.zeros((*se.shape[:-1], E), dtype=se.dtype,
                         device=se.device).scatter_add_(
                             -1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, -1) - counts                 # exclusive
    rank = torch.arange(S * K, device=xg.device) - torch.gather(starts, -1,
                                                                se)
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank, E * capacity)
    return slot, st, torch.where(keep, sg, 0.0), me, ce, order


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, run: RunConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(output, aux load-balance loss); x (B, S, D), B the groups.

    ``run.moe_combine`` picks the reference's activation constraints on
    the dispatch and combine buffers (``sharding.constrain``, nothing on
    one device): ``"default"`` pins the expert buffers to (batch,
    experts); ``"reshard"`` also brings the combine buffer back to batch
    sharding before the gather; ``"a2a"`` shards the sorted-token dim of
    the dispatched and gathered rows over the model axis."""
    if is_dtensor(x):
        return _moe_on_mesh(p, x, cfg, run)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    cd = run.compute_dtype
    C = _capacity(S, cfg)

    # --- routing (fp32 for numerics), every group at once ------------------
    slots, st, sg, me, ce, order = _route_group(
        x.float(), p["router"].float(), cfg, C)
    aux = E * torch.sum(torch.mean(me, 0) * torch.mean(ce, 0))
    y = _dispatch_combine(p, x, slots, st, sg, order, cfg, run, 0, E)
    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x, cfg, run).to(cd)
    return y.to(x.dtype), aux.float()


def _dispatch_combine(p: Params, x: torch.Tensor, slots, st, sg, order,
                      cfg: ModelConfig, run: RunConfig, e0: int, e1: int
                      ) -> torch.Tensor:
    """Dispatch into the expert buffer, the expert FFN and the combine,
    for the experts ``[e0, e1)`` whose weights ``p`` holds (all of them
    off a mesh); a choice of another expert contributes zero."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    cd = run.compute_dtype
    C = _capacity(S, cfg)
    if (e0, e1) != (0, E):
        # slots of other experts (and overflows) go to the dump row
        local = (slots >= e0 * C) & (slots < e1 * C)
        slots = torch.where(local, slots - e0 * C, (e1 - e0) * C)
        E = e1 - e0

    # --- dispatch: per-group scatter into the (E, C) expert buffer ----------
    xg = torch.gather(x.to(cd), 1, st[..., None].expand(B, S * K, D))
    if run.moe_combine == "a2a":
        xg = constrain(xg, run, "batch", "seq", None)
    buf = torch.zeros((B, E * C + 1, D), dtype=cd, device=x.device)
    buf = buf.scatter(1, slots[..., None].expand(B, S * K, D), xg)
    buf = buf[:, :-1].reshape(B, E, C, D)
    # the group axis stays on data, the expert axis moves to model
    buf = constrain(buf, run, "batch", "experts", None, None)

    # --- expert FFN: silu gate whatever cfg.act, as the reference ----------
    g = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(cd))
    u = torch.einsum("becd,edf->becf", buf, p["w_up"].to(cd))
    h = F.silu(g) * u
    out_buf = torch.einsum("becf,efd->becd", h, p["w_down"].to(cd))
    out_buf = constrain(out_buf, run, "batch", "experts", None, None)

    # --- combine: each token's K rows in (s, k) order, gate-weighted, summed
    # the inverse permutation: choice s·K + k sits at sorted position inv
    inv = torch.zeros_like(order).scatter_(
        -1, order, torch.arange(S * K, device=x.device).expand_as(order))
    flat = out_buf.reshape(B, E * C, D)
    if run.moe_combine == "reshard":
        flat = constrain(flat, run, "batch", None, None)
    flat = torch.cat([flat, torch.zeros((B, 1, D), dtype=cd,
                                        device=x.device)], 1)
    rows = torch.gather(slots, 1, inv)                         # (B, S*K)
    gathered = torch.gather(flat, 1, rows[..., None].expand(B, S * K, D))
    if run.moe_combine == "a2a":
        gathered = constrain(gathered, run, "batch", "seq", None)
    gates = torch.gather(sg, 1, inv).to(cd)
    y = torch.sum((gathered * gates[..., None]).reshape(B, S, K, D), dim=2)

    return y


def _moe_on_mesh(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 run: RunConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` of a DTensor ``x`` (a run on a mesh): expert
    parallelism over ``"model"``.

    The routing and the dispatch are per group, so each rank routes its
    own groups (rows of its batch shard, whole over the model axis) on
    local tensors; the sort-based dispatch has no DTensor sharding rule.
    Each model rank runs the FFN of its own experts (their weights
    sharded on the experts dim, gathered over the data axes under FSDP),
    and its combine adds only their rows: the output is a partial sum
    over the model axis — the reference's "the combine's expert
    reduction becomes the TP all-reduce" — and so are the gradients of
    ``x`` and of the router (each rank's share through its experts).  The
    aux loss's per-group terms enter divided by the model-axis size as a
    partial sum, so its value and its gradient count once.  Where the
    experts do not divide the model axis every rank runs all of them and
    nothing is partial.  The three ``moe_combine`` lowerings are one
    here."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    E = cfg.n_experts
    mi = names.index("model") if "model" in names else None
    n = mesh.size(mi) if mi is not None else 1
    split = n > 1 and E % n == 0 and run.tp
    red = Partial() if split else Replicate()
    rows, rows_grad, w_grad = [], [], []
    for i, name in enumerate(names):
        if i == mi:
            rows.append(Replicate())
            rows_grad.append(red)
            w_grad.append(red)
        elif x.shape[0] % mesh.size(i) == 0:
            rows.append(Shard(0))
            rows_grad.append(Shard(0))
            w_grad.append(Partial())
        else:
            rows.append(Replicate())
            rows_grad.append(Replicate())
            w_grad.append(Replicate())
    xl = x.redistribute(mesh, rows).to_local(grad_placements=rows_grad)
    rep = [Replicate()] * len(names)
    router = p["router"].redistribute(mesh, rep).to_local(
        grad_placements=w_grad)
    e0, e1 = (0, E)
    wpl, wgrad = rep, w_grad
    if split:
        r = mesh.get_local_rank(mi)
        e0, e1 = r * E // n, (r + 1) * E // n
        wpl = [Shard(0) if i == mi else Replicate()
               for i in range(len(names))]
        wgrad = [Shard(0) if i == mi else g for i, g in enumerate(w_grad)]
    pl = {k: p[k].redistribute(mesh, wpl).to_local(grad_placements=wgrad)
          for k in ("w_gate", "w_up", "w_down")}
    B, S, D = xl.shape
    C = _capacity(S, cfg)
    slots, st, sg, me, ce, order = _route_group(xl.float(), router.float(),
                                                cfg, C)
    y = _dispatch_combine(pl, xl, slots, st, sg, order, cfg, run, e0, e1)
    out_pl = [red if i == mi else r_ for i, r_ in enumerate(rows)]
    shape = (x.shape[0], S, D)
    y = DTensor.from_local(y, mesh, out_pl, run_check=False,
                           shape=torch.Size(shape),
                           stride=(S * D, D, 1))
    scale = n if split else 1
    me_d, ce_d = (DTensor.from_local(t / scale, mesh, out_pl,
                                     run_check=False,
                                     shape=torch.Size((x.shape[0], E)),
                                     stride=(E, 1)) for t in (me, ce))
    aux = E * torch.sum(torch.mean(me_d, 0) * torch.mean(ce_d, 0))
    cd = run.compute_dtype
    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x, cfg, run).to(cd)
    return y.to(x.dtype), aux.float()
