"""Paged KV-cache (port of ``repro.serve.paged_kv``): fixed-size pages and
a free-list, vLLM-style.

The cache is a *pool* of fixed-size pages shared by every slot: each slot
owns an ordered page list (its page-table row) and its pages return to
the free-list the tick its request completes, so resident cache bytes
track the tokens alive.

Layout (one pool per K and V):

* ``k_store / v_store``: ``(L, n_pages + 1, page_size, K, hd)`` tensors on
  the device — the storage of truth.  The last page is the *drop page*:
  no slot ever owns it and no read gathers it; a write whose page id is
  ``-1`` (or past the pool) lands there (:func:`drop_pages`).
  ``k_pool / v_pool`` are the views of the ``n_pages`` real pages, the
  reference's pool;
* ``page_table``: ``(n_slots, pages_per_slot)`` host int32, ``-1`` = not
  allocated; row order is token order (logical position ``p`` lives in
  page ``table[slot, p // page_size]`` at offset ``p % page_size``);
* ``free``: host free-list of page ids (LIFO — recently freed pages are
  re-used first).

The consumers never loop over pages: they gather a slot's pages into a
dense ``(L, S_pad, K, hd)`` view (one ``index_select``) and scatter new
tokens back by ``(page, offset)`` pairs, a ``-1`` page id masking the
write — which is how padded chunk positions and inactive slots are kept
out of the pool.  The reference means its ``mode="drop"`` scatter to do
this, but JAX normalizes a negative index before the drop test, so there
a ``-1`` writes into page ``n_pages - 1``; the drop page gives the port
the masking the reference describes (ROADMAP §3).

Allocation is host-side bookkeeping; the invariant — every page is free
or owned by exactly one slot — is checked by :meth:`PagedKVCache.check`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

DEFAULT_PAGE_SIZE = 16


def drop_pages(pages: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Page ids with every id outside ``[0, n_pages)`` sent to the drop
    page ``n_pages``."""
    return torch.where((pages >= 0) & (pages < n_pages), pages, n_pages)


class PagedKVCache:
    """Fixed-page KV pool shared by ``n_slots`` sequences, on ``device``
    (``"cuda"`` unless the caller asks for the host)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 n_pages: int | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = -(-max_len // page_size)      # ceil
        # default pool = full reservation (decode growth can never fail);
        # smaller pools exercise allocation pressure in tests
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.pages_per_slot)
        self.dtype = dtype
        self.device = resolve_device(device)
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shape = (L, self.n_pages + 1, page_size, K, hd)
        self.k_store = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_store = torch.zeros(shape, dtype=dtype, device=self.device)
        self.page_table = np.full((n_slots, self.pages_per_slot), -1,
                                  np.int32)
        self.lengths = np.zeros(n_slots, np.int32)          # tokens stored
        self.free: list[int] = list(range(self.n_pages - 1, -1, -1))

    @property
    def k_pool(self) -> torch.Tensor:
        """(L, n_pages, page_size, K, hd): the real pages of K."""
        return self.k_store[:, :self.n_pages]

    @property
    def v_pool(self) -> torch.Tensor:
        return self.v_store[:, :self.n_pages]

    # -- allocator ---------------------------------------------------------
    @property
    def n_used(self) -> int:
        return self.n_pages - len(self.free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages a sequence of ``n_tokens`` occupies."""
        return -(-n_tokens // self.page_size)

    def slot_pages(self, slot: int) -> list[int]:
        row = self.page_table[slot]
        return [int(p) for p in row if p >= 0]

    def alloc(self, slot: int, upto_len: int) -> bool:
        """Grow ``slot``'s page list to cover ``upto_len`` tokens.

        All-or-nothing: returns False (allocating nothing) when the
        free-list can't cover the growth — never a partially-grown slot.
        """
        if upto_len > self.max_len:
            return False
        need = self.pages_for(upto_len)
        have = len(self.slot_pages(slot))
        if need - have > len(self.free):
            return False
        for i in range(have, need):
            self.page_table[slot, i] = self.free.pop()
        return True

    def release(self, slot: int) -> int:
        """Return every page of ``slot`` to the free-list; pages freed."""
        pages = self.slot_pages(slot)
        self.free.extend(reversed(pages))
        self.page_table[slot] = -1
        self.lengths[slot] = 0
        return len(pages)

    def check(self) -> None:
        """Allocator invariants: free + owned == all, no page owned twice."""
        owned = [int(p) for row in self.page_table for p in row if p >= 0]
        if len(set(owned)) != len(owned):
            raise AssertionError(f"page owned twice: {sorted(owned)}")
        if set(owned) & set(self.free):
            raise AssertionError("page both free and owned: "
                                 f"{sorted(set(owned) & set(self.free))}")
        if len(owned) + len(self.free) != self.n_pages:
            raise AssertionError(
                f"page leak: {len(owned)} owned + {len(self.free)} free "
                f"!= {self.n_pages} total")

    # -- device-view helpers ----------------------------------------------
    @property
    def padded_len(self) -> int:
        """Dense per-slot view length (``pages_per_slot * page_size``)."""
        return self.pages_per_slot * self.page_size

    def table_device(self) -> torch.Tensor:
        return torch.as_tensor(self.page_table, device=self.device)

    def write_coords(self, slot: int, start: int, n: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(page_ids, offsets) for logical positions ``start..start+n-1``.

        Positions beyond an allocated page get page id ``-1`` (the write
        is dropped) — callers pad with ``n`` larger than the valid token
        count and rely on the drop.
        """
        pos = start + np.arange(n)
        page_idx = pos // self.page_size
        in_range = page_idx < self.pages_per_slot
        pages = np.where(in_range,
                         self.page_table[slot, np.minimum(
                             page_idx, self.pages_per_slot - 1)],
                         -1).astype(np.int32)
        offs = (pos % self.page_size).astype(np.int32)
        return pages, offs

    # -- host-side read/write (tests + reference path) ---------------------
    def write(self, slot: int, start: int, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Store ``k``/``v`` ``(L, T, K, hd)`` at logical ``start`` (a
        helper — the engine scatters inside its executables instead)."""
        T = k.shape[1]
        if not self.alloc(slot, start + T):
            raise ValueError(
                f"slot {slot}: cannot allocate {start + T} tokens "
                f"({len(self.free)} pages free)")
        pages, offs = self.write_coords(slot, start, T)
        pg = drop_pages(torch.as_tensor(pages, device=self.device),
                        self.n_pages)
        of = torch.as_tensor(offs, device=self.device)
        # adjacent advanced indices: the selected shape is (L, T, K, hd)
        self.k_store[:, pg, of] = k.to(self.device, self.dtype)
        self.v_store[:, pg, of] = v.to(self.device, self.dtype)
        self.lengths[slot] = max(int(self.lengths[slot]), start + T)

    def read(self, slot: int, length: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dense ``(L, length, K, hd)`` K and V of one slot."""
        n = int(self.lengths[slot]) if length is None else length
        row = torch.as_tensor(self.page_table[slot], device=self.device)
        out = []
        for pool in (self.k_pool, self.v_pool):
            pages = pool.index_select(1, row.clamp(min=0))  # (L, P, page, K, hd)
            out.append(pages.reshape(pool.shape[0], self.padded_len,
                                     *pool.shape[3:])[:, :n])
        return out[0], out[1]
