"""Continuous-batching serving engine over a paged KV-cache (port of
``repro.serve.engine``).

Requests arrive on a tick clock, wait in a bounded FIFO queue, and are
admitted into one of ``n_slots`` sequence slots backed by the shared
:class:`~repro_torch.serve.paged_kv.PagedKVCache` page pool.  Each engine
tick

1. admits queue heads while a slot *and* enough free pages exist (FIFO —
   the head blocks, so admission order is arrival order),
2. advances every prefilling slot by one prompt chunk (chunked prefill
   interleaved with decode — a long prompt never stalls the running
   decodes for more than one chunk),
3. runs one batched decode step over all decoding slots,
4. retires finished sequences (EOS / ``max_new`` / context-full),
   returning their pages to the free-list the same tick.

Three executables, plain callables on tensors that the engine runs under
``torch.inference_mode()`` and times to the card's completion
(``torch.cuda.synchronize``); the object the engine times is the object
the op walk (``core/op_analysis.py::analyze_fn``, on meta tensors)
analyzes (``serve/trace.py``) — the reference's one-compile rule:

* ``prefill_first(params, chunk, valid, k_store, v_store, wpage, woff)``
  — the start-of-prompt chunk: causal self-attention over the chunk
  only; under fusion an eligible chunk routes to the flash kernel (the
  chunked → flash seam);
* ``prefill_ext(params, chunk, start, valid, k_store, v_store, page_row,
  wpage, woff)`` — later chunks: gathers the slot's paged context dense
  and attends the chunk against context + itself;
* ``decode(params, tokens, k_store, v_store, table, lengths, wpage,
  woff)`` — one token for every slot: gather pages → dense
  ``DecodeState`` → ``model.decode_fn`` → scatter the new K/V back
  (inactive slots carry page id ``-1``: their writes land in the drop
  page, :func:`~repro_torch.serve.paged_kv.drop_pages`).

Each writes the pools in place (the reference's donated buffers) and
returns them beside the logits.  Faults degrade gracefully: empty
prompts, prompts past ``max_len`` and queue overflow are rejected with a
reason; mid-stream cancellation frees the slot and pages immediately;
pool exhaustion finishes the sequence ``truncated`` instead of wedging
the engine.  The engine runs on the card unless ``device="cpu"`` is
asked for, and its parameters must live on that device.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.op_analysis import to_meta
from repro_torch.device import resolve_device
from repro_torch.models.api import Model, build
from repro_torch.resilience import faults
from repro_torch.serve.paged_kv import (DEFAULT_PAGE_SIZE, PagedKVCache,
                                        drop_pages)

#: families the engine can serve: token-only prompts + a paged KV cache
#: (as the reference: a VLM's patches and an enc-dec's memory are not
#: served)
SERVABLE_FAMILIES = ("dense", "moe")

#: phase each executable's wall time lands in
PHASE_OF = {"prefill_first": "prefill", "prefill_ext": "prefill",
            "decode": "decode"}


@dataclasses.dataclass
class Request:
    """One user request; the engine fills the tracking fields in."""

    uid: int
    prompt: np.ndarray                # (len,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    arrival: int = 0                  # arrival tick (virtual clock)
    status: str = "new"               # new|queued|active|done|rejected|cancelled
    finish_reason: str | None = None  # length|eos|truncated|... when done
    admit_tick: int | None = None
    first_tick: int | None = None
    done_tick: int | None = None
    t_arrival: float | None = None    # wall-clock stamps (metrics)
    t_first: float | None = None
    t_done: float | None = None


@dataclasses.dataclass
class _Slot:
    """One active sequence: its request + prefill progress + next token."""

    req: Request
    phase: str                        # "prefill" | "decode"
    filled: int = 0                   # prompt tokens prefilled so far
    next_tok: int = 0


class Engine:
    """Continuous-batching engine over a dense or MoE model.

    A MoE block routes each executable call's tokens as its groups, as
    the reference's engine does: a prefill chunk (padded tail included;
    the stable sort keeps the padding behind the prompt in every expert)
    is one group, each decode slot's token another, each with its own
    capacity.  So a MoE request's logits follow its chunking: they equal
    a forward over the same groups, not one over the whole sequence where
    a full expert drops other tokens."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params: Any,
                 n_slots: int = 4, max_len: int = 256,
                 eos_id: int | None = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 n_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 queue_capacity: int | None = None,
                 tick_retries: int = 2,
                 device: str | torch.device = "cuda"):
        if cfg.family not in SERVABLE_FAMILIES:
            raise ValueError(
                f"Engine serves token-prompt KV-cache families "
                f"{SERVABLE_FAMILIES}; got {cfg.family!r} "
                "(ssm/hybrid carry recurrent state — decode those via "
                "repro_torch.models.api)")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.device = resolve_device(device)
        elsewhere = {str(t.device) for t in tree_flatten(params)[0]
                     if isinstance(t, torch.Tensor)
                     and t.device != self.device}
        if elsewhere:
            raise ValueError(f"the engine runs on {self.device}, but "
                             f"parameters live on {sorted(elsewhere)}")
        self.cfg, self.run, self.params = cfg, run, params
        self.n_slots, self.max_len, self.eos_id = n_slots, max_len, eos_id
        self.chunk = min(prefill_chunk or 32, max_len)
        self.queue_capacity = queue_capacity
        self.model: Model = build(cfg)
        self.cache = PagedKVCache(cfg, n_slots, max_len,
                                  page_size=page_size, n_pages=n_pages,
                                  device=self.device)
        self._slots: list[_Slot | None] = [None] * n_slots
        self.queue: deque[Request] = deque()
        self.tick_count = 0
        self.tick_retries = tick_retries
        self.retried_ticks = 0
        # each executable's per-call walls (s), in call order (the trace
        # layer's input, through ``wall`` and ``calls``)
        self.call_walls: dict[str, list[float]] = {name: []
                                                   for name in PHASE_OF}
        # while ``keep_logits``: (executable, fp32 copy of its logits) for
        # each call, in call order
        self.keep_logits = False
        self.logits: list[tuple[str, torch.Tensor]] = []
        self._built: dict[str, Any] = {}

    # ------------------------------------------------------------------
    # executables (built once, lazily; timed and analyzed as the same
    # object)
    # ------------------------------------------------------------------

    def executable(self, name: str):
        if name not in self._built:
            self._built[name] = getattr(self, f"_build_{name}")()
        return self._built[name]

    def _timed(self, name: str, *args):
        fn = self.executable(name)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.call_walls[name].append(time.perf_counter() - t0)
        if self.keep_logits:
            self.logits.append((name, out[0].float().clone()))
        return out

    @property
    def wall(self) -> dict[str, float]:
        """Summed wall (s) per executable."""
        return {name: sum(w) for name, w in self.call_walls.items()}

    @property
    def calls(self) -> dict[str, int]:
        """Calls per executable."""
        return {name: len(w) for name, w in self.call_walls.items()}

    def _i32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _prefill_body(self, params, chunk, start, valid, k_store, v_store,
                      attend, wpage, woff):
        """Shared chunk-prefill math: the residual stream of ``chunk``
        (C,) evolved layer by layer with exactly ``block_apply``'s op
        sequence (norm → attention → residual-norm seam → mlp or MoE
        block → residual), with attention delegated to ``attend(qg, k, v,
        kp, vp)`` and the chunk's per-layer K/V written to the page pool at
        ``(wpage, woff)`` (``-1`` page ids go to the drop page — the
        padding mask).  The logits are the chunk's at ``valid - 1``.
        """
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as TR
        from repro_torch.models.params import unstack_layers

        cfg, run = self.cfg, self.run
        C = chunk.shape[0]
        cd = run.compute_dtype
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        G = H // K
        positions = start + torch.arange(C, device=chunk.device)
        wp = drop_pages(wpage, k_store.shape[1] - 1)

        x = L.embed_apply(params["embed"], chunk[None], run)     # (1, C, D)
        for i, lp in enumerate(unstack_layers(params["blocks"])):
            kp, vp = k_store[i], v_store[i]     # (n_pages + 1, page, K, hd)
            xn = L.rmsnorm_apply(lp["ln_attn"], x, cfg.norm_eps, run)
            xc = xn.to(cd)
            q = torch.einsum("bsd,dhk->bshk", xc, lp["attn"]["wq"].to(cd))
            k = torch.einsum("bsd,dhk->bshk", xc, lp["attn"]["wk"].to(cd))
            v = torch.einsum("bsd,dhk->bshk", xc, lp["attn"]["wv"].to(cd))
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
            out = attend(q.reshape(1, C, K, G, hd), k, v, kp, vp)
            y = torch.einsum("bshk,hkd->bsd", out.reshape(1, C, H, hd),
                             lp["attn"]["wo"].to(cd)).to(x.dtype)
            h2, z = L.rmsnorm_residual_apply(lp["ln_mlp"], x, y,
                                             cfg.norm_eps, run)
            z, _ = TR.ffn_apply(lp, z, cfg, run)
            kp.index_put_((wp, woff), k[0].to(kp.dtype))
            vp.index_put_((wp, woff), v[0].to(vp.dtype))
            x = h2 + z
        x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps, run)
        # the reference's dynamic index clamps into the chunk
        last = x.index_select(1, (valid - 1).clamp(0, C - 1).reshape(1))
        logits = L.unembed_apply(params["embed"], last, run)[0, 0]  # (V,)
        return logits, k_store, v_store

    def _build_prefill_first(self):
        """Start-of-prompt chunk: causal self-attention over the chunk
        only — the flash-routable shape.  Under fusion an eligible chunk
        routes to the flash kernel (``fusion="auto"`` also asks the
        measured dispatch table); otherwise the masked plain sdpa runs."""
        from repro_torch.kernels.fused import ops as fops
        from repro_torch.models import layers as L

        C = self.chunk
        cfg, run = self.cfg, self.run
        cd = run.compute_dtype
        sd = torch.float32 if run.softmax_f32 else cd
        K, hd = cfg.n_kv_heads, cfg.head_dim
        G = cfg.n_heads // K
        use_flash = (fops.fusion_enabled(run)
                     and fops.use_flash_from_chunked(
                         run, (1, C, K, G, hd), (1, C, K, hd), cd,
                         causal=True, has_memory=False, has_cache=False,
                         softmax_f32=run.softmax_f32,
                         chunk=run.attn_chunk, device=self.device))
        self.prefill_first_flash = use_flash

        def prefill_first(params, chunk, valid, k_store, v_store, wpage,
                          woff):
            positions = torch.arange(C, device=chunk.device)

            def attend(qg, k, v, kp, vp):
                # padded tail keys sit at positions >= valid, which the
                # causal mask already hides from every valid query — so
                # the plain-causal flash kernel needs no k_len mask here
                if use_flash:
                    from repro_torch.kernels.flash_attention import \
                        ops as fa_ops
                    return fa_ops.flash_attention_gqa(qg, k.to(cd),
                                                      v.to(cd))
                return L._sdpa(qg, k.to(cd), v.to(cd), positions, positions,
                               causal=True, k_len=valid, stat_dtype=sd)

            return self._prefill_body(
                params, chunk, torch.zeros((), dtype=torch.int32,
                                           device=chunk.device),
                valid, k_store, v_store, attend, wpage, woff)

        return prefill_first

    def _build_prefill_ext(self):
        """Later chunks: gather the slot's paged context dense, attend
        the chunk against context + itself (causal, length-masked)."""
        from repro_torch.models import layers as L

        C = self.chunk
        S_pad = self.cache.padded_len
        cd = self.run.compute_dtype
        sd = torch.float32 if self.run.softmax_f32 else cd

        def prefill_ext(params, chunk, start, valid, k_store, v_store,
                        page_row, wpage, woff):
            pos = start + torch.arange(C, device=chunk.device)
            k_pos = torch.arange(S_pad, device=chunk.device)

            def overlay(pool, fresh):
                # this slot's paged context, dense (S_pad, K, hd), with
                # the chunk's own fresh rows written over it; a row past
                # S_pad is dropped (written into C spare rows cut off)
                ctx = pool.index_select(0, page_row.clamp(min=0))
                ctx = ctx.reshape(S_pad, *ctx.shape[2:])
                ctx = torch.cat([ctx, ctx.new_zeros((C, *ctx.shape[1:]))])
                return ctx.index_copy(0, pos, fresh.to(ctx.dtype))[:S_pad]

            def attend(qg, k, v, kp, vp):
                ctxk, ctxv = overlay(kp, k[0]), overlay(vp, v[0])
                return L._sdpa(qg, ctxk[None].to(cd), ctxv[None].to(cd), pos,
                               k_pos, causal=True, k_len=start + valid,
                               stat_dtype=sd)

            return self._prefill_body(params, chunk, start, valid, k_store,
                                      v_store, attend, wpage, woff)

        return prefill_ext

    def _build_decode(self):
        """One batched decode tick: paged gather → dense DecodeState →
        ``model.decode_fn`` → scatter the new K/V back."""
        from repro_torch.models.transformer import DecodeState

        B = self.n_slots
        S_pad = self.cache.padded_len
        run, decode_fn = self.run, self.model.decode_fn

        def decode(params, tokens, k_store, v_store, table, lengths, wpage,
                   woff):
            rows = table.clamp(min=0).reshape(-1)
            L_ = k_store.shape[0]
            dense_k = k_store.index_select(1, rows).reshape(
                L_, B, S_pad, *k_store.shape[3:])
            dense_v = v_store.index_select(1, rows).reshape(
                L_, B, S_pad, *v_store.shape[3:])
            state = DecodeState(k=dense_k, v=dense_v, length=lengths)
            logits, new_state = decode_fn(params, {"tokens": tokens}, state,
                                          run)
            bidx = torch.arange(B, device=tokens.device)
            at = lengths.clamp(0, S_pad - 1)   # the reference's gather clamps
            wp = drop_pages(wpage, k_store.shape[1] - 1)
            k_store[:, wp, woff] = new_state.k[:, bidx, at].to(k_store.dtype)
            v_store[:, wp, woff] = new_state.v[:, bidx, at].to(v_store.dtype)
            return logits[:, 0], k_store, v_store

        return decode

    def example_args(self, name: str) -> tuple:
        """Meta stand-ins of one call's arguments (the walk's inputs: the
        shapes and dtypes each call of ``name`` takes)."""
        C, B, P = self.chunk, self.n_slots, self.cache.pages_per_slot

        def i32(*shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        params = to_meta(self.params)
        ks, vs = to_meta((self.cache.k_store, self.cache.v_store))
        if name == "decode":
            return (params, i32(B, 1), ks, vs, i32(B, P), i32(B), i32(B),
                    i32(B))
        if name == "prefill_first":
            return (params, i32(C), i32(), ks, vs, i32(C), i32(C))
        if name == "prefill_ext":
            return (params, i32(C), i32(), i32(), ks, vs, i32(P), i32(C),
                    i32(C))
        raise KeyError(f"unknown executable {name!r}; known: "
                       f"{sorted(PHASE_OF)}")

    # ------------------------------------------------------------------
    # admission / faults
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue one request; False = rejected (reason on the request)."""
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        if len(req.prompt) == 0:
            req.status, req.finish_reason = "rejected", "empty_prompt"
            return False
        if len(req.prompt) > self.max_len:
            req.status, req.finish_reason = "rejected", "prompt_too_long"
            return False
        if (self.queue_capacity is not None
                and len(self.queue) >= self.queue_capacity):
            req.status, req.finish_reason = "rejected", "queue_full"
            return False
        req.status = "queued"
        self.queue.append(req)
        return True

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or running request; its pages free immediately."""
        for req in list(self.queue):
            if req.uid == uid:
                self.queue.remove(req)
                req.status, req.finish_reason = "cancelled", "cancelled"
                req.done = True
                return True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.uid == uid:
                slot.req.status = "cancelled"
                slot.req.finish_reason = "cancelled"
                slot.req.done = True
                self._release(i)
                return True
        return False

    def _release(self, slot_idx: int) -> None:
        self.cache.release(slot_idx)
        self._slots[slot_idx] = None

    def _finish(self, slot_idx: int, reason: str) -> None:
        req = self._slots[slot_idx].req
        req.status, req.finish_reason, req.done = "done", reason, True
        req.done_tick = self.tick_count
        req.t_done = time.perf_counter()
        self._release(slot_idx)

    def _admit_from_queue(self) -> None:
        """FIFO head-of-line admission: a slot plus enough free pages."""
        while self.queue:
            req = self.queue[0]
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            slot = free[0]
            if not self.cache.alloc(slot, len(req.prompt)):
                return                      # head waits for pages (FIFO)
            self.queue.popleft()
            req.status = "active"
            req.admit_tick = self.tick_count
            self._slots[slot] = _Slot(req=req, phase="prefill", filled=0)

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------

    def _prefill_step(self, slot_idx: int) -> None:
        """Advance one prefilling slot by one prompt chunk."""
        slot = self._slots[slot_idx]
        req = slot.req
        prompt = np.asarray(req.prompt, np.int32)
        start = slot.filled
        valid = min(self.chunk, len(prompt) - start)
        chunk = np.zeros(self.chunk, np.int32)
        chunk[:valid] = prompt[start:start + valid]
        wpage, woff = self.cache.write_coords(slot_idx, start, self.chunk)
        # positions past the valid token count never land in the pool
        wpage[valid:] = -1
        i32 = self._i32
        stores = (self.cache.k_store, self.cache.v_store)
        if start == 0:
            logits, *_ = self._timed(
                "prefill_first", self.params, i32(chunk), i32(valid),
                *stores, i32(wpage), i32(woff))
        else:
            logits, *_ = self._timed(
                "prefill_ext", self.params, i32(chunk), i32(start),
                i32(valid), *stores, i32(self.cache.page_table[slot_idx]),
                i32(wpage), i32(woff))
        slot.filled = start + valid
        self.cache.lengths[slot_idx] = slot.filled
        if slot.filled < len(prompt):
            return                          # more chunks next tick
        # prompt complete: the chunk's last logits give the first token
        tok = int(torch.argmax(logits[:self.cfg.vocab_size]))
        req.out.append(tok)
        req.first_tick = self.tick_count
        req.t_first = time.perf_counter()
        slot.next_tok = tok
        slot.phase = "decode"
        self._maybe_finish(slot_idx, tok)

    def _maybe_finish(self, slot_idx: int, tok: int) -> None:
        """Completion checks after a token landed; frees the slot."""
        slot = self._slots[slot_idx]
        req = slot.req
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(slot_idx, "eos")
        elif len(req.out) >= req.max_new:
            self._finish(slot_idx, "length")
        elif int(self.cache.lengths[slot_idx]) >= self.max_len:
            # no room to write the next input token's K/V
            self._finish(slot_idx, "truncated")

    def _decode_step(self) -> None:
        """One batched decode over every decoding slot."""
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.phase == "decode"]
        # pool pressure: growing past a page boundary may fail on an
        # undersized pool — finish those sequences truncated, pre-decode
        for i in list(active):
            if not self.cache.alloc(i, int(self.cache.lengths[i]) + 1):
                self._finish(i, "truncated")
                active.remove(i)
        if not active:
            return
        B = self.n_slots
        tokens = np.zeros((B, 1), np.int32)
        wpage = np.full(B, -1, np.int32)
        woff = np.zeros(B, np.int32)
        for i in active:
            slot = self._slots[i]
            tokens[i, 0] = slot.next_tok
            pg, of = self.cache.write_coords(i, int(self.cache.lengths[i]),
                                             1)
            wpage[i], woff[i] = pg[0], of[0]
        i32 = self._i32
        logits, *_ = self._timed(
            "decode", self.params, i32(tokens), self.cache.k_store,
            self.cache.v_store, self.cache.table_device(),
            i32(self.cache.lengths), i32(wpage), i32(woff))
        toks = torch.argmax(logits[:, :self.cfg.vocab_size], dim=-1).tolist()
        for i in active:
            slot = self._slots[i]
            self.cache.lengths[i] += 1
            tok = int(toks[i])
            slot.req.out.append(tok)
            slot.next_tok = tok
            self._maybe_finish(i, tok)

    def tick(self) -> None:
        """One engine step: admit → prefill chunks → decode → retire."""
        faults.active_plan().maybe_raise("serve_fault",
                                        target=self.tick_count)
        self._admit_from_queue()
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.phase == "prefill":
                self._prefill_step(i)
        self._decode_step()
        self.tick_count += 1

    def _tick_resilient(self) -> None:
        """``tick`` with bounded retry on transient faults.

        The fault hook fires before any admission or cache mutation, so
        a retried tick replays cleanly from the same engine state.
        """
        for attempt in range(self.tick_retries + 1):
            try:
                return self.tick()
            except faults.TransientFault:
                if attempt >= self.tick_retries:
                    raise
                self.retried_ticks += 1

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    # ------------------------------------------------------------------
    # running a trace
    # ------------------------------------------------------------------

    def run_trace(self, requests: list[Request], max_ticks: int = 4096):
        """Serve an arrival trace to completion; returns ServeStats.

        Requests are submitted when the tick clock reaches their
        ``arrival``; rejected ones stay rejected (reason on the request).
        """
        from repro_torch.serve.metrics import stats_from_requests

        t0 = time.perf_counter()
        start_tick = self.tick_count
        pending = sorted(requests, key=lambda r: r.arrival)
        i = 0
        while self.tick_count - start_tick < max_ticks:
            while i < len(pending) \
                    and pending[i].arrival <= self.tick_count:
                self.submit(pending[i])
                i += 1
            if i == len(pending) and not self.queue \
                    and self.n_active == 0:
                break
            self._tick_resilient()
        prefill_wall = (self.wall["prefill_first"]
                        + self.wall["prefill_ext"])
        return stats_from_requests(
            requests, wall_s=time.perf_counter() - t0,
            ticks=self.tick_count - start_tick,
            prefill_wall_s=prefill_wall,
            decode_wall_s=self.wall["decode"])

    def serve(self, requests: list[Request], max_ticks: int = 512
              ) -> list[Request]:
        """Serve a list to completion, return it."""
        self.run_trace(requests, max_ticks=max_ticks)
        return requests
