"""Check and time the hand-written flash-attention kernels on one CUDA card.

Builds ``src/repro_torch/kernels/csrc/flash.cu`` (printing the ``ptxas``
register, spill and warning report), holds ``flash_attention_grouped``
against its plain version ``ops._ref_gqa`` at ``ref.kernel_tolerance`` on
a ladder of shapes — one query tile and one key tile, one and two 64-wide
boxes of hd, several wraps of the K/V ring, causal and not, ragged S and
hd, GQA with Sk != Sq, every hd route, fp16 — and the log-sum-exp it
writes against ``torch.logsumexp`` of the plain scores; then the backward
kernel's gradients through the routed op against the plain fp32 vjp at
``ref.bwd_kernel_tolerance`` (``chip_smoke.flash_bwd_checks``) on a ladder
from one tile up to ``chip_smoke.FLASH_BWD_SHAPES``; and times the main
path's shape (bf16 q (2, 2048, 32, 128), 2 KV heads, causal) beside
``F.scaled_dot_product_attention``, and the backward at glm4-9b's cell
shape beside the plain recompute and SDPA's backward::

    python tools/flash_check.py                 # check, then time
    python tools/flash_check.py --watchdog --no-time
    python tools/flash_check.py --rounds 3
    python tools/flash_check.py --bwd-only      # the backward alone

``--watchdog`` builds with ``-DERT_GEMM_WATCHDOG`` (through
``REPRO_NVCC_FLAGS``; the mbarrier waits of ``csrc/hopper.cuh``): a wait
that never completes traps (a failed launch) instead of hanging the card.
Times replay a CUDA graph of 20 calls (``chip_smoke.graph_ms``), operands
rotating past the L2, kernel and SDPA in turns (kernel, SDPA, SDPA,
kernel) each round.  Exits 1 on the first mismatch, after printing which
(16-row, 64-column) blocks of the first query tile of head 0 are wrong.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAIN = (2, 2048, 2, 16, 128)
#: (B, Sq, KV heads, G, hd, Sk or None for Sq, dtype, causal): from one
#: tile up, so a broken descriptor, fragment order or barrier shows at the
#: smallest shape
SHAPES = (
    (1, 128, 1, 1, 64, None, "bfloat16", False),
    (1, 128, 1, 1, 128, None, "bfloat16", False),
    (1, 64, 1, 1, 128, None, "bfloat16", True),
    (1, 512, 1, 1, 128, None, "bfloat16", False),
    (1, 512, 1, 2, 128, None, "bfloat16", True),
    (1, 640, 1, 2, 64, None, "bfloat16", True),
    (1, 300, 1, 2, 72, None, "bfloat16", False),
    (1, 77, 2, 2, 8, None, "bfloat16", True),
    (1, 130, 1, 4, 24, None, "float16", True),
    (1, 1000, 2, 2, 128, None, "float16", True),
    (2, 300, 2, 3, 128, 700, "bfloat16", True),
    (2, 700, 2, 3, 128, 300, "bfloat16", False),
    (1, 129, 2, 1, 136, None, "bfloat16", True),
    (1, 300, 1, 2, 256, None, "bfloat16", True),
    (2, 1, 1, 2, 16, None, "bfloat16", True),
    (*MAIN, None, "bfloat16", True),
    (*MAIN, None, "float16", True),
    (*MAIN, None, "bfloat16", False),
    (1, 4096, 2, 16, 128, None, "bfloat16", True),
)


#: the backward's ladder before chip_smoke.FLASH_BWD_SHAPES: one key and
#: query tile, both boxes of hd, the causal diagonal, a ring that wraps,
#: the head slices, ragged S, hd 8 (q shape, dtype, causal, Sk or none)
BWD_LADDER = (
    ((1, 64, 1, 1, 64), "bfloat16", False),
    ((1, 128, 1, 1, 128), "bfloat16", False),
    ((1, 128, 1, 1, 128), "bfloat16", True),
    ((1, 512, 1, 2, 64), "bfloat16", True),
    ((1, 512, 2, 4, 128), "bfloat16", True),
    ((1, 200, 1, 3, 40), "float16", True),
    ((1, 77, 2, 2, 8), "bfloat16", False),
)


def lse_check(dev) -> bool:
    """The forward's log-sum-exp against ``torch.logsumexp`` of the plain
    scaled, masked fp32 scores, within 2e-5 of max(1, |lse|)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device=dev).manual_seed(3)
    ok = True
    for (b, sq, kv, grp, hd), sk, dt, causal in (
            ((1, 300, 2, 3, 128), 700, "bfloat16", True),
            ((2, 257, 1, 2, 64), None, "float16", False),
            ((1, 130, 1, 4, 24), None, "float32", True),
            ((1, 2048, 2, 16, 128), None, "bfloat16", True)):
        dtype = getattr(torch, dt)
        sk = sk or sq
        q = torch.randn((b, sq, kv, grp, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((b, sk, kv, hd), generator=g, device=dev).to(dtype)
        _, lse = torch.ops.repro_torch.flash_attention(q, k, k, causal)
        want = torch.logsumexp(ops._scores(q, k, causal), -1)
        worst = ((lse - want).abs() / (2e-5 * want.abs().clamp(min=1))).max()
        good = worst.item() <= 1.0
        ok &= good
        print(f"  lse {dt} q {(b, sq, kv, grp, hd)} sk {sk} causal={causal}: "
              f"max err/tol {worst.item():.3f} {'ok' if good else 'MISMATCH'}")
    return ok


def bwd_check(dev, time_it: bool) -> bool:
    from chip_smoke import FLASH_BWD_SHAPES, flash_bwd_checks
    from repro_torch.core.machine import H100_SXM
    try:
        rows = flash_bwd_checks(dev, H100_SXM, BWD_LADDER + FLASH_BWD_SHAPES,
                                time_it=time_it)
    except AssertionError as err:
        print(f"  backward MISMATCH: {err}")
        return False
    for r in rows:
        print(f"  {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms "
              f"(eager {r['eager_ms']:.4f}) | plain {r['plain_ms']:.4f} ms | "
              f"SDPA backward {r['library_ms']:.4f} ms | bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | {r['extra']}")
    return True


def block_map(bad) -> str:
    """Which (16-row, 64-column) blocks of the first 128 rows of (row, col)
    ``bad`` hold an error: one character a block, ``X`` wrong."""
    rows = []
    for r in range(0, min(bad.shape[0], 128), 16):
        rows.append("".join("X" if bad[r:r + 16, c:c + 64].any() else "."
                            for c in range(0, bad.shape[1], 64)))
    return " ".join(rows)


def check(dev) -> bool:
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device=dev).manual_seed(0)
    for b, sq, kv, grp, hd, sk, dt, causal in SHAPES:
        dtype = getattr(torch, dt)
        sk = sk or sq
        q = torch.randn((b, sq, kv, grp, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((b, sk, kv, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((b, sk, kv, hd), generator=g, device=dev).to(dtype)
        out = fk.flash_attention_grouped(q, k, v, causal=causal)[0]
        torch.cuda.synchronize()
        want = ops._ref_gqa(q, k, v, causal)
        d = (out.float() - want.float()).abs()
        worst = (d / ref.kernel_tolerance(want)).max().item()
        ok = worst <= 1.0 and torch.isfinite(out).all().item()
        print(f"  {fk.route(hd, dtype):<5} {dt} q {(b, sq, kv, grp, hd)} "
              f"sk {sk} causal={causal}: max_abs_err {d.max().item():.3e} "
              f"max err/tol {worst:.3f} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad = (d > ref.kernel_tolerance(want))[0, :, 0, 0]
            print(f"    wrong blocks of q tile 0, head 0: {block_map(bad)}")
            print(f"    out[0, 0, 0, 0, :8] {out[0, 0, 0, 0, :8].float().tolist()}")
            print(f"    ref[0, 0, 0, 0, :8] {want[0, 0, 0, 0, :8].float().tolist()}")
            return False
        del q, k, v, out, want, d
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--watchdog", action="store_true",
                    help="trap a pipeline wait that never completes")
    ap.add_argument("--no-time", action="store_true", help="check only")
    ap.add_argument("--rounds", type=int, default=2, help="timing rounds")
    ap.add_argument("--bwd-only", action="store_true",
                    help="the backward's checks (and time) alone")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_check: no CUDA card", file=sys.stderr)
        return 1
    if args.watchdog:
        os.environ["REPRO_NVCC_FLAGS"] = " ".join(
            (os.environ.get("REPRO_NVCC_FLAGS", ""), "-DERT_GEMM_WATCHDOG"))
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F
    from chip_smoke import graph_ms, rotating
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    path, secs = build.build("flash", verbose=True)
    print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s")
    if not args.bwd_only and not (check(dev) and lse_check(dev)):
        return 1
    if not bwd_check(dev, not args.no_time):
        return 1
    if args.no_time or args.bwd_only:
        print(smi)
        return 0

    b, s, kv, grp, hd = MAIN
    g = torch.Generator(device=dev).manual_seed(1)

    def make():
        return (torch.randn((b, s, kv, grp, hd), generator=g,
                            device=dev).to(torch.bfloat16),
                torch.randn((b, s, kv, hd), generator=g,
                            device=dev).to(torch.bfloat16),
                torch.randn((b, s, kv, hd), generator=g,
                            device=dev).to(torch.bfloat16))

    _, nxt = rotating(make, k=2)
    for r in range(args.rounds):
        for causal in (True, False):
            def kernel(q, k, v):
                return fk.flash_attention_grouped(q, k, v, causal=causal)

            def sdpa(q, k, v):
                return F.scaled_dot_product_attention(
                    q.flatten(2, 3).transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2), is_causal=causal, enable_gqa=True)

            flop = fk.flops(b * kv * grp, s, s, hd, causal=causal)
            times = {kernel: [], sdpa: []}
            for fn in (kernel, sdpa, sdpa, kernel):
                times[fn].append(graph_ms(lambda: fn(*nxt())))
            kern, lib = min(times[kernel]), min(times[sdpa])
            print(f"  time bf16 q {MAIN} causal={causal} round {r}: kernel "
                  f"{kern:.4f} ms ({flop / kern / 1e9:.1f} TFLOP/s) | SDPA "
                  f"{lib:.4f} ms ({flop / lib / 1e9:.1f}) | kernel / SDPA "
                  f"{kern / lib:.3f}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
