"""Dispatch-table smoke: search twice, the second pass 100% cached (port
of ``benchmarks/dispatch_smoke.py``).

The measured dispatch (``repro_torch.tune.dispatch``) promises that a
site is measured *once* per (site, machine): the first ``tune dispatch
search`` over a store times every fused-against-reference site the train
step meets and persists the winners; every later search, and every
``fusion="auto"`` trace, routes by lookups that cost nothing.  As a gate:

* pass 1 over a fresh store: every site measured, the table persisted;
* pass 2 over the *same* store: **zero re-timings** (``n_measured ==
  0``); anything else raises.

The sites are measured on the device (the hand-written kernels against
their plain chains on the card; both plain on the host).  The store lands
in a throwaway directory, so the first search always starts empty.

Run: ``python -m repro_torch.bench --only dispatch_smoke [--device cpu]``.
"""

from __future__ import annotations

import tempfile
import time

import torch

from repro_torch.bench.common import Row

SMOKE_CONFIG = "minitron-4b"
SMOKE_SEQ = 16
SMOKE_BATCH = 2


def smoke_rows(config: str = SMOKE_CONFIG, seq: int = SMOKE_SEQ,
               batch: int = SMOKE_BATCH,
               device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.tune import dispatch as dsp
    from repro_torch.tune.store import TuneStore

    out: list[Row] = []
    with tempfile.TemporaryDirectory() as tmp:
        store_path = f"{tmp}/tune.json"
        store = TuneStore(store_path)

        t0 = time.perf_counter()
        first = dsp.search_sites(config, seq=seq, batch=batch, store=store,
                                 device=device)
        wall1 = (time.perf_counter() - t0) * 1e6
        out.append(("dispatch_smoke/search_first", wall1,
                    f"sites={first.n_sites};measured={first.n_measured};"
                    f"hits={first.n_hit}"))
        if first.n_sites == 0:
            raise AssertionError(
                f"dispatch search over {config} encountered no sites — "
                "the fusion='auto' trace is not reaching the routers")

        t0 = time.perf_counter()
        second = dsp.search_sites(config, seq=seq, batch=batch, store=store,
                                  device=device)
        wall2 = (time.perf_counter() - t0) * 1e6
        out.append(("dispatch_smoke/search_second", wall2,
                    f"sites={second.n_sites};measured={second.n_measured};"
                    f"hits={second.n_hit};cached={second.all_cached}"))
        if second.n_measured != 0:
            raise AssertionError(
                f"second dispatch search re-timed {second.n_measured} "
                f"site(s) — the store must make it a 100% hit "
                f"({second.n_hit} hit(s) of {second.n_sites} site(s))")

        table = dsp.dispatch_table(store)
        n_fused = sum(1 for r in table if r.impl == "fused")
        out.append(("dispatch_smoke/table", 0.0,
                    f"winners={len(table)};fused={n_fused};"
                    f"reference={len(table) - n_fused};"
                    f"store={store_path}"))
    return out


def main(device: str | torch.device = "cuda") -> list[Row]:
    return smoke_rows(device=device)
