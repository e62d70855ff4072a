"""Measured train-step wall of the smoke configs (port of
``benchmarks/train_throughput.py``).

Not a paper table: the operational benchmark that keeps the substrate
honest — each arch's smoke train step (seq 64, batch 4, AMP O1) must
run, and reports tokens/s on the device it ran on (CUDA events on the
card, the host clock on the host).

Run: ``python -m repro_torch.bench --only train_throughput
[--device cpu]``.
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import Row, timed

ARCHS = ("minitron-4b", "glm4-9b", "mamba2-1.3b", "zamba2-1.2b",
         "granite-moe-1b-a400m", "seamless-m4t-large-v2")


def main(device: str | torch.device = "cuda") -> list[Row]:
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import api as M
    from repro_torch.train.step import init_state, make_train_step

    dev = resolve_device(device)
    rows: list[Row] = []
    shape = ShapeSpec("t", 64, 4, "train")
    run = RunConfig(amp="O1")
    for arch in ARCHS:
        cfg = get_smoke(arch)
        model = M.build(cfg)
        gen = torch.Generator(dev).manual_seed(0)
        state = init_state(model, run, gen, dev)
        step = make_train_step(model, run)
        batch = M.synthetic_batch(cfg, shape, 4, gen, dev)
        # the step updates params and moments in place: each timed call
        # is one more step of the same run
        us = timed(step, state, batch, iters=3, warmup=1, device=dev)
        toks = 4 * shape.seq_len
        rows.append((f"train_throughput/{arch}", us,
                     f"{toks/(us/1e6):.0f}tok/s"))
    return rows
