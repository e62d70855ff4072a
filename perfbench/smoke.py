"""Cells at a size a CPU test can hold: a workload's files with the
model's sizes replaced by the program's smoke configuration of the same
architecture and a short mix.  Every layer kind and setting of the cell
stays; only the sizes shrink."""

from __future__ import annotations

import copy
import dataclasses

from perfbench.bench import Cell

#: the program's smoke configuration of each reference family
SMOKE_OF = {"dense": "glm4-9b", "mamba2": "mamba2-1.3b"}


def small_cell(name: str, seq_len: int = 64, **run) -> Cell:
    from repro_torch.configs.registry import get_smoke
    cell = Cell.load(name)
    cfg = copy.deepcopy(cell.config)
    smoke = dataclasses.asdict(get_smoke(SMOKE_OF[cell.family]))
    cfg["model"].update({k: v for k, v in smoke.items()
                         if k in cfg["model"]})
    cfg["run"].update(run)
    mix = dict(cell.mix, seq_len=seq_len)
    return Cell.load(name, config=cfg, mix=mix)
