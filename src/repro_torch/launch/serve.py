"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``
(port of ``repro.launch.serve``).

Spins up the paged-KV continuous-batching engine with random weights (or
a checkpoint) and serves a seeded synthetic arrival trace, reporting
throughput, latency percentiles and per-phase (prefill/decode) wall.
For the roofline-attributed, workspace-persisted variant use
``python -m repro_torch serve``.

``--ckpt`` reads the parameters of a checkpoint that
``repro_torch.train.trainer.Trainer`` wrote (leaves ``params/...`` of a
train state; the AdamW moments are neither loaded nor moved to the
device), or of one that holds a bare parameter tree.  The reference
restores a bare tree only, so it cannot serve its own trainer's
checkpoints (``ROADMAP.md`` §3).

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --smoke --requests 8 --max-new 16 --device cpu
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import ALL, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import api as M
from repro_torch.models.params import init
from repro_torch.serve.engine import SERVABLE_FAMILIES, Engine
from repro_torch.serve.workload import make_trace


def load_params(directory: str, like, device: torch.device):
    """The parameters of the newest checkpoint under ``directory``, cast
    to ``like``'s dtypes on ``device``: a train state's ``params/``
    leaves when it holds them, else a bare parameter tree."""
    names = ckpt.leaf_names(directory)
    if any(n.startswith("params/") for n in names):
        tree, _ = ckpt.restore(directory, {"params": like}, device=device)
        return tree["params"]
    return ckpt.restore(directory, like, device=device)[0]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=list(ALL))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--trace", default="poisson",
                    choices=("poisson", "bursty"))
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None, help="restore params from here")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family not in SERVABLE_FAMILIES:
        print(f"[serve] engine serves token-prompt KV-cache families "
              f"{SERVABLE_FAMILIES}; {cfg.family} models decode via "
              "repro_torch.models.api decode_fn")
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:            # no CUDA device for --device cuda
        print(f"[serve] {e}", file=sys.stderr)
        return 2
    run = RunConfig(amp="O1")
    model = M.build(cfg)
    if args.ckpt:
        like = init(model.spec, None, run.param_dtype, "meta")
        params = load_params(args.ckpt, like, dev)
    else:
        gen = torch.Generator(dev).manual_seed(args.seed)
        params = init(model.spec, gen, run.param_dtype, dev)

    engine = Engine(cfg, run, params, n_slots=args.slots,
                    max_len=args.max_len, page_size=args.page_size,
                    prefill_chunk=args.prefill_chunk, device=dev)
    reqs = make_trace(args.trace, args.requests, rate=args.rate,
                      seed=args.seed, vocab=cfg.vocab_size,
                      prompt_len=(4, min(16, args.max_len)),
                      max_new=(args.max_new, args.max_new))
    stats = engine.run_trace(reqs)
    print(stats.render())
    problems = stats.gate()
    for p in problems:
        print(f"[serve] GATE: {p}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
