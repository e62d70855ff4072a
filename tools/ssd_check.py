"""Check and time the hand-written SSD scan (and the triad) on one CUDA card.

Builds ``src/repro_torch/kernels/csrc/ssd.cu`` alone (printing the
``ptxas`` register, shared-memory and spill report), holds ``ssd_scan``
against its plain version ``ref.ssd_ref`` at ``ref.kernel_tolerance``
(1e-4 of each (b, h, chunk) block's own max) at the shapes of
``chip_smoke.py``'s SSD checks (``chip_smoke.SSD_SHAPES``: the main
shape at chunks 256 and 128, the reference's test shapes, one chunk, no
decay, an underflowing decay, and a ragged P and N), and times the main
path's shape (f32 xh (2, 2048, 64, 64), N 128, chunk 256, model layout)
beside its bounds and the plain ``ssd_chunked``::

    python tools/ssd_check.py                    # check, then time
    python tools/ssd_check.py --no-time --profile
    python tools/ssd_check.py --triad --watchdog # and the triad

``--watchdog`` builds with ``-DERT_GEMM_WATCHDOG`` (through
``REPRO_NVCC_FLAGS``): an mbarrier wait of ``csrc/hopper.cuh`` that never
completes (the bulk-copy triad's) traps, a failed launch, instead of
hanging the card; the SSD kernels wait on none.  ``--profile`` prints the
device time of each of the scan's launches (``torch.profiler``).
``--triad`` also builds ``ert.cu``, holds ``triad`` at 1 ulp at
``ops.FULL``'s HBM size (2^26 f32 elements), its L2 size and ragged
sizes, and times it at the HBM size (8 passes a launch) and the L2 size
(512 passes) beside ``torch.add(b, a, alpha=3.0)`` repeated as many
times, in turns, as ``characterize`` times it (``ops.time_launches``).
The scan's times replay a CUDA graph of 20 calls
(``chip_smoke.graph_ms``), operands rotating past the L2.  Exits 1 on
the first mismatch.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def check_ssd(dev) -> bool:
    """The SSD kernel at ``chip_smoke.SSD_SHAPES``."""
    import torch
    from chip_smoke import SSD_SHAPES, ssd_operands
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref
    g = torch.Generator(device=dev).manual_seed(3)
    for (b, h, s, p, n, q), a_kind in SSD_SHAPES:
        x, a, bm, cm = ssd_operands(g, dev, b, h, s, p, n, a_kind=a_kind)
        out = sk.ssd_scan(x, a, bm, cm, chunk=q)
        torch.cuda.synchronize()
        want = ref.ssd_ref(x, a, bm, cm, chunk=q)
        d = (out - want).abs()
        worst = (d / ref.kernel_tolerance(want, q)).max().item()
        ok = worst <= 1.0 and torch.isfinite(out).all().item()
        print(f"  ssd {b}x{h}x{s}x{p} N={n} Q={q} a={a_kind}: "
              f"max_abs_err {d.max().item():.3e} max err/tol {worst:.4f} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad = (d > ref.kernel_tolerance(want, q)).any(-1)   # (B, H, S)
            rows = bad.nonzero()[:8].tolist()
            print(f"    first wrong (b, h, s): {rows}")
            return False
    return True


def time_ssd(dev, rounds: int, profile: bool = False) -> None:
    import torch
    from chip_smoke import TF32_PEAK, bound, graph_ms, rotating, ssd_operands
    from repro_torch.core.machine import H100_SXM
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models.ssm import ssd_chunked
    b, h, s, p, n, q = 2, 64, 2048, 64, 128, 256
    g = torch.Generator(device=dev).manual_seed(4)
    _, nxt = rotating(lambda: ssd_operands(g, dev, b, h, s, p, n,
                                           layout="model"), k=2)
    need = sk.needed_flops(b, h, s, p, n, q)
    execd = sk.executed_flops(b, h, s, p, n, q)
    nbytes = sk.hbm_bytes(b, h, s, p, n)
    fma_bound = bound(nbytes, need, "f32", H100_SXM)["bound_ms"]
    tf32_bound = bound(nbytes, 3 * need, "tf32", H100_SXM,
                       peak=TF32_PEAK)["bound_ms"]
    print(f"  main shape: needed {need / 1e9:.4f} GFLOP, executed by the "
          f"passes {execd / 1e9:.4f} GFLOP ({3 * execd / 1e9:.4f} on the "
          f"tensor cores in 3xTF32), {nbytes / 1e6:.1f} MB; bound on FMAs "
          f"{fma_bound:.4f} ms, on 3xTF32 {tf32_bound:.4f} ms")
    for r in range(rounds):
        ms = graph_ms(lambda: sk.ssd_scan_model(*nxt(), chunk=q))
        print(f"  time ssd main shape round {r}: {ms:.4f} ms | "
              f"{need / ms / 1e9:.2f} needed TFLOP/s | "
              f"{100 * tf32_bound / ms:.1f}% of the 3xTF32 bound, "
              f"{100 * fma_bound / ms:.1f}% of the FMA bound")
    plain = graph_ms(lambda: ssd_chunked(*nxt(), q), calls=2)
    print(f"  plain ssd_chunked: {plain:.4f} ms")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        sk.ssd_scan_model(*nxt(), chunk=q)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                sk.ssd_scan_model(*nxt(), chunk=q)
            torch.cuda.synchronize()
        print("  profile of 10 calls:")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=8,
                                        max_name_column_width=40))


def check_and_time_triad(dev, rounds: int) -> bool:
    import torch
    from chip_smoke import check
    from repro_torch.kernels.ert import bandwidth, ops, ref
    full = ops.FULL
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(k, dtype):
        return torch.rand((k,), generator=g, device=dev).to(dtype)

    for dtype, k, reps in ((torch.float32, full.hbm_n, 1),
                           (torch.float32, full.hbm_n + 3, 1),
                           (torch.float32, full.l2_n, 3),
                           (torch.float32, 1_000_003, 2),
                           (torch.bfloat16, full.hbm_n + 5, 1),
                           (torch.float16, 4099, 1)):
        a, b = rand(k, dtype), rand(k, dtype)
        want = ref.triad_ref(a, b)
        ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8
        try:
            check(f"triad {str(dtype)[6:]} n={k} reps={reps}",
                  bandwidth.triad(a, b, reps=reps), want,
                  ulp * want.float().abs().max().item())
        except AssertionError:
            return False
        del a, b, want
    for r in range(rounds):
        for k, reps in ((full.hbm_n, full.hbm_reps),
                        (full.l2_n, full.l2_reps)):
            a, b = rand(k, torch.float32), rand(k, torch.float32)
            nbytes = bandwidth.triad_bytes(k, 4) * reps
            fns = {"triad": lambda: bandwidth.triad(a, b, reps=reps),
                   "torch.add": lambda: [torch.add(b, a, alpha=3.0)
                                         for _ in range(reps)]}
            times = {label: [] for label in fns}
            for label in [*fns, *reversed(fns)]:
                times[label].append(1e3 * ops.time_launches(fns[label], dev))
            for label, ts in times.items():
                ms = min(ts)
                print(f"  time triad f32 n={k} reps={reps} round {r} "
                      f"{label}: {ms:.4f} ms = {nbytes / ms / 1e9:.3f} TB/s "
                      f"(both: {', '.join(f'{t:.4f}' for t in ts)})")
            del a, b
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-time", action="store_true", help="check only")
    ap.add_argument("--profile", action="store_true",
                    help="print each pass's device time (torch.profiler)")
    ap.add_argument("--watchdog", action="store_true",
                    help="trap an mbarrier wait that never completes")
    ap.add_argument("--rounds", type=int, default=1, help="timing rounds")
    ap.add_argument("--triad", action="store_true",
                    help="also check and time the triad beside torch.add")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ssd_check: no CUDA card", file=sys.stderr)
        return 1
    if args.watchdog:
        os.environ["REPRO_NVCC_FLAGS"] = " ".join(
            (os.environ.get("REPRO_NVCC_FLAGS", ""), "-DERT_GEMM_WATCHDOG"))
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.kernels import build
    from repro_torch.kernels import config as kc
    from repro_torch.kernels.ssd_scan import kernel as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    names = ["ssd", "ert"] if args.triad else ["ssd"]
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda name: build.build(name, verbose=True),
                            names))
    for name, (path, secs) in zip(names, built):
        print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s")

    lib = build.load("ssd")
    want = tuple(int(kc.default_config("ssd_scan").get(k))
                 for k in sk._TILE_KEYS)
    got = tuple(lib.ssd_tile(i) for i in range(len(want)))
    if got != want:
        print(f"ssd.cu is compiled for {got}, the config states {want}",
              file=sys.stderr)
        return 1
    if not check_ssd(dev):
        return 1
    if not args.no_time:
        time_ssd(dev, args.rounds, args.profile)
    if args.triad and not check_and_time_triad(
            dev, 0 if args.no_time else args.rounds):
        return 1
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
