"""Where a DeepCAM training step's time goes on one CUDA card, and what
determinism costs.

At the paper's size (stem width 64, 768×1152×16 images, batch 2, AMP O1,
the ``fused`` lowering, ``fusion="static"``), through
``repro_torch.launch.train.make_trainer`` as ``python -m
repro_torch.launch.train`` runs it:

1. the host's ms per ``ClimateStream`` batch;
2. DeepCAM's last resize ((2, 192, 288, 256) → (768, 1152), bf16)
   forward + backward, 3 times on one gradient and then timed, three
   ways: ATen's kernels (the backward adds with atomics), ATen under
   ``torch.use_deterministic_algorithms`` (its gather decomposition), and
   the port's ``_resize`` under them (ATen's forward, the backward as two
   products: ``models.deepcam._DeterministicResize``) — whether the runs
   agree bit for bit, and the wall of each;
3. ``--steps`` steps of the trainer for each of prefetch 0 (batches made
   inline) and 2 (on the prefetch thread) × deterministic algorithms off
   and on: the step walls and the fit's wall;
4. with ``--profile``, one step of each mode under ``torch.profiler``
   (CPU and CUDA activity): the aten ops that take the most device time.

Run on the card::

    python tools/train_check.py [--steps 6] [--profile]

It builds ``kernels/csrc/fused.cu`` (the AdamW launch) through
``build.build``, as the wrappers do.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resize_repeats(device, shape=(2, 192, 288, 256), hw=(768, 1152)) -> None:
    import torch
    from repro_torch.models import deepcam as DC

    g = torch.Generator(device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    x.requires_grad_()
    dy = torch.randn((shape[0], *hw, shape[3]), generator=g,
                     device=device).to(torch.bfloat16)
    for label, fn, det in (("ATen", DC._interpolate, False),
                           ("ATen, deterministic", DC._interpolate, True),
                           ("port, deterministic", DC._resize, True)):
        torch.use_deterministic_algorithms(det)
        try:
            runs = [torch.autograd.grad(fn(x, hw), x, dy)[0]
                    for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                torch.autograd.grad(fn(x, hw), x, dy)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
        finally:
            torch.use_deterministic_algorithms(False)
        same = all(torch.equal(runs[0], r) for r in runs[1:])
        err = (runs[0].float() - runs[1].float()).abs().max().item()
        verdict = "agree bit for bit" if same else "differ"
        print(f"  resize {shape} -> {hw}, {label:<20}: fwd + bwd "
              f"{ms:8.3f} ms; 3 runs {verdict} (largest difference "
              f"{err:.3e})", flush=True)


def steps(n: int, profile: bool) -> None:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as LT

    cfg = get_config("deepcam")
    run = RunConfig(amp="O1", fusion="static", impl="fused")
    for prefetch in (0, 2):
        for det in (False, True):
            t = LT.make_trainer(cfg, run, smoke=False, batch=2, seq=0,
                                device="cuda", prefetch=prefetch,
                                deterministic=det)
            t0 = time.perf_counter()
            rep = t.fit(n, log_every=0)
            wall = time.perf_counter() - t0
            walls = [round(1e3 * x, 3) for x in rep.step_times]
            print(f"  prefetch {prefetch}, deterministic {det!s:<5}: step "
                  f"walls {walls} ms; fit {wall:.3f} s; losses "
                  f"{[round(x, 6) for x in rep.losses]}", flush=True)
            del t
    if not profile:
        return
    for det in (False, True):
        t = LT.make_trainer(cfg, run, smoke=False, batch=2, seq=0,
                            device="cuda", prefetch=0, deterministic=det)
        t.fit(2, log_every=0)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t.fit(3, log_every=0)                  # one step: 2 -> 3
        ev = sorted((e for e in prof.key_averages()
                     if e.key.startswith("aten::")),
                    key=lambda e: -e.device_time_total)
        print(f"  one step, deterministic {det}: aten ops by device time",
              flush=True)
        for e in ev[:12]:
            print(f"    {e.key:<36} device {e.device_time_total / 1e3:9.3f}"
                  f" ms x{e.count:<5} host {e.cpu_time_total / 1e3:9.3f} ms")
        del t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("train_check: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.deepcam import IMAGE_HW
    from repro_torch.data.pipeline import ClimateStream
    from repro_torch.device import describe_gpu
    from repro_torch.kernels import build

    print(f"{describe_gpu()['smi']} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda}", flush=True)
    build.build("fused")
    stream = ClimateStream(IMAGE_HW, 2)
    t0 = time.perf_counter()
    for i in range(3):
        stream(i)
    print(f"  ClimateStream (2, {IMAGE_HW[0]}, {IMAGE_HW[1]}, 16): "
          f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms a batch on the "
          "host", flush=True)
    resize_repeats(torch.device("cuda", 0))
    steps(args.steps, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
