"""Check and time the hand-written ``ert_gemm`` kernel on one CUDA card.

Builds ``src/repro_torch/kernels/csrc/ert.cu`` (printing the ``ptxas``
register, spill and warning report), holds the kernel against its plain
version ``matmul_ref`` at a ladder of shapes — one tile and one K step,
a full ring, several wraps of it, ragged M, N and K, 8192³ in every
input and output dtype — and times it in bf16 beside ``torch.matmul`` at
the sizes given::

    python tools/ert_gemm_check.py                     # check + time 8192³
    python tools/ert_gemm_check.py --watchdog --time   # check only
    python tools/ert_gemm_check.py --time 4096 8192 --rounds 4 \
        --data uniform centred normal --soak 5

``--watchdog`` builds with ``-DERT_GEMM_WATCHDOG`` (through
``REPRO_NVCC_FLAGS``): a pipeline wait that never completes traps (a
failed launch) instead of hanging the card.  Each timing round times
every ``--data`` kind in turn, in the opposite order on odd rounds, each
both as the GEMM ceilings are timed (``ops.time_gemm``: a replayed CUDA
graph, least of 3 samples) and eagerly (``search.time_min``: CUDA events
around back-to-back launches, least of 3), then prints the card's
temperature, SM clock and power draw.  ``--soak`` runs the kernel for
that many seconds before each round but the first.  The kinds: ``uniform`` in [0, 1)
(``ops.gemm_operands``, what the ceilings use), ``centred`` in
[-0.5, 0.5), ``normal`` N(0, 0.25).  Tolerance as ``chip_smoke.py``:
2^-7 of max|ref| for a 16-bit output, 1e-5 for an f32 one.  Exits 1 on
the first mismatch, after printing where in the (16-row, 64-column)
blocks of the first tile it lies.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (in dtype, out dtype or None, (M, N, K)): from one tile and one K step
#: up, so a broken descriptor or barrier shows at the smallest shape
SHAPES = (
    ("bfloat16", None, (128, 256, 64)),
    ("bfloat16", "float32", (128, 256, 256)),
    ("bfloat16", "float32", (128, 256, 640)),
    ("float16", "float32", (256, 512, 1024)),
    ("bfloat16", "float32", (256, 384, 96)),
    ("bfloat16", None, (1000, 1000, 1000)),
    ("bfloat16", None, (8, 8, 8)),
    ("float16", None, (1024, 256, 2048)),
    ("bfloat16", None, (8192, 8192, 8192)),
    ("float16", None, (8192, 8192, 8192)),
    ("bfloat16", "float32", (8192, 8192, 8192)),
    ("float32", None, (2048, 2048, 2048)),
)


def block_map(err, tol) -> str:
    """Which (16-row, 64-column) blocks of the first 128 x 256 tile hold an
    error above ``tol``: one character a block, ``X`` wrong, ``.`` right."""
    rows = []
    for r in range(0, min(err.shape[0], 128), 16):
        rows.append("".join(
            "X" if err[r:r + 16, c:c + 64].max().item() > tol else "."
            for c in range(0, min(err.shape[1], 256), 64)))
    return " ".join(rows)


def check(gemm, ref, dev) -> bool:
    """Every shape of :data:`SHAPES` against the plain version."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    for dt, odt, (m, n, k) in SHAPES:
        dtype = getattr(torch, dt)
        out_dtype = getattr(torch, odt) if odt else dtype
        a = torch.rand((m, k), generator=g, device=dev).to(dtype) - 0.5
        b = torch.rand((k, n), generator=g, device=dev).to(dtype) - 0.5
        out = gemm.matmul(a, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = ref.matmul_ref(a, b, out_dtype)
        err = (out.float() - want.float()).abs()
        scale = want.float().abs().max().item()
        tol = (1e-5 if out_dtype == torch.float32 else 2.0 ** -7) * scale \
            + 1e-6
        worst = err.max().item()
        print(f"  {dt}->{str(out_dtype)[6:]} {m}x{n}x{k}: max_abs_err "
              f"{worst:.3e} tol {tol:.3e} "
              f"{'ok' if worst <= tol else 'MISMATCH'}")
        if not worst <= tol:
            print(f"    wrong blocks of the first tile: {block_map(err, tol)}")
            print(f"    out[0, :8] {out[0, :8].float().tolist()}")
            print(f"    ref[0, :8] {want[0, :8].float().tolist()}")
            return False
    return True


def operands(kind: str, size: int, dev):
    import torch
    from repro_torch.kernels.ert import ops
    a, b = ops.gemm_operands(size, size, size, torch.float32, dev)
    if kind == "centred":
        a, b = a - 0.5, b - 0.5
    elif kind == "normal":
        g = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn(a.shape, generator=g, device=dev) * 0.5
        b = torch.randn(b.shape, generator=g, device=dev) * 0.5
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def card_state() -> str:
    """The card's temperature, SM clock and power draw now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=temperature.gpu,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--watchdog", action="store_true",
                    help="trap a pipeline wait that never completes")
    ap.add_argument("--time", type=int, nargs="*", default=[8192],
                    help="square bf16 sizes to time (none: check only)")
    ap.add_argument("--data", nargs="+", default=["uniform"],
                    choices=("uniform", "centred", "normal"),
                    help="operands of the timing")
    ap.add_argument("--rounds", type=int, default=1,
                    help="timing rounds over the --data kinds")
    ap.add_argument("--soak", type=float, default=0.0,
                    help="seconds of back-to-back launches before each "
                         "round but the first")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ert_gemm_check: no CUDA card", file=sys.stderr)
        return 1
    if args.watchdog:
        os.environ["REPRO_NVCC_FLAGS"] = " ".join(
            (os.environ.get("REPRO_NVCC_FLAGS", ""), "-DERT_GEMM_WATCHDOG"))
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.ert import gemm, ops, ref
    from repro_torch.tune.search import time_min

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    path, secs = build.build("ert", verbose=True)
    print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s")
    if not check(gemm, ref, dev):
        return 1

    for size in args.time:
        flop = gemm.gemm_flops(size, size, size)
        data = {kind: operands(kind, size, dev) for kind in args.data}
        for r in range(args.rounds):
            if args.soak > 0 and r > 0:
                a, b = data[args.data[0]]
                t_end = time.perf_counter() + args.soak
                while time.perf_counter() < t_end:
                    for _ in range(20):
                        gemm.matmul(a, b)
                    torch.cuda.synchronize()
            for kind in (args.data if r % 2 == 0 else args.data[::-1]):
                a, b = data[kind]
                row = []
                for name, fn in (("ert_gemm", lambda: gemm.matmul(a, b)),
                                 ("torch.matmul",
                                  lambda: torch.matmul(a, b))):
                    t_g = ops.time_gemm(fn, dev)
                    t_e = time_min(fn, dev, 3, 1)
                    row.append(f"{name} graph {t_g * 1e3:.4f} ms "
                               f"({flop / t_g / 1e12:.1f} TFLOP/s) eager "
                               f"{t_e * 1e3:.4f} ms "
                               f"({flop / t_e / 1e12:.1f})")
                print(f"  time bf16 {size}^3 round {r} {kind}: "
                      + " | ".join(row))
            print(f"  card after round {r}: {card_state()}")
        del data
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
