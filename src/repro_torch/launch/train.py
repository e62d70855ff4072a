"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``repro.launch.train``).

Runs a real training loop on one device (the card by default; ``--device
cpu`` on the host) with the port's model and train step: deterministic
data made on a prefetch thread and put on the device, async checkpoints
with restart, straggler logging (see ``repro_torch.train.trainer``).
``--arch deepcam`` trains on :class:`~repro_torch.data.pipeline.
ClimateStream` at the paper's resolution (``IMAGE_HW``; ``SMOKE_HW``
with ``--smoke``); every other arch on ``TokenStream``.  There is no
mesh: sharding belongs to the multi-GPU slice.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepcam \\
        --smoke --steps 20 --batch 4 --device cpu --ckpt build/ck
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.configs.registry import ALL, get_config, get_smoke
from repro_torch.data.pipeline import ClimateStream, TokenStream
from repro_torch.models import api as M
from repro_torch.train.trainer import TrainReport, Trainer

#: batches kept ready on the prefetch thread
PREFETCH = 2


def make_stream(cfg: ModelConfig, *, smoke: bool, batch: int, seq: int):
    """The data stream of an arch: ``ClimateStream`` at the DeepCAM
    resolution for the ``cnn`` family, else ``TokenStream`` at ``seq``."""
    if cfg.family == "cnn":
        from repro_torch.configs.deepcam import IMAGE_HW, SMOKE_HW
        return ClimateStream(SMOKE_HW if smoke else IMAGE_HW, batch)
    return TokenStream(cfg, ShapeSpec("cli", seq, batch, "train"), batch)


def make_trainer(cfg: ModelConfig, run: RunConfig, *, smoke: bool,
                 batch: int, seq: int, lr: float = 3e-4,
                 ckpt: str | None = None, ckpt_every: int = 50,
                 device: str | torch.device = "cuda",
                 prefetch: int = PREFETCH, **trainer_kw) -> Trainer:
    """The trainer :func:`main` runs: ``cfg``'s model and stream, a
    prefetch thread, checkpoints under ``ckpt``."""
    stream = make_stream(cfg, smoke=smoke, batch=batch, seq=seq)
    return Trainer(M.build(cfg), run, stream, ckpt_dir=ckpt,
                   ckpt_every=ckpt_every, lr=lr, device=device,
                   prefetch=prefetch, **trainer_kw)


def summary(report: TrainReport) -> str:
    """The reference's summary line."""
    times = report.step_times
    mean = 1e3 * sum(times[1:]) / max(len(times) - 1, 1)
    final = report.losses[-1] if report.losses else float("nan")
    return (f"[train] {report.steps} steps, final loss {final:.4f}, "
            f"mean step {mean:.1f} ms, stragglers {len(report.stragglers)}, "
            f"resumed_from={report.resumed_from}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=list(ALL))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--amp", default="O1", choices=("O0", "O1", "O2"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=("none", "dots", "full"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the trainer's deterministic algorithms on the card want cuBLAS's
    # workspace fixed before the first product (PyTorch's size on an H100)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(amp=args.amp, remat=args.remat,
                    microbatches=args.microbatches)
    try:
        trainer = make_trainer(cfg, run, smoke=args.smoke, batch=args.batch,
                               seq=args.seq, lr=args.lr, ckpt=args.ckpt,
                               ckpt_every=args.ckpt_every,
                               device=args.device)
    except RuntimeError as e:            # no CUDA device for --device cuda
        print(f"[train] {e}", file=sys.stderr)
        return 2
    print(summary(trainer.fit(args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
