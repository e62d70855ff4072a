#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``; it builds the
hand-written kernels from ``src/repro_torch/kernels/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the kernels (printing ``ptxas`` register / shared-memory use);
3. holds each kernel against its plain PyTorch version on the card, at
   the shapes ``characterize`` uses and at odd sizes, and times kernel,
   plain version and library call beside the datasheet bound;
4. drives the main path with every launch count at 0: machine
   characterization (``Session.characterize(empirical=True)``, the ladder
   and the GEMM size sweep, each ceiling checked against 1.05x its
   datasheet value), then the full-width, full-depth glm4-9b fwd phase
   (``Session.profile(..., measure=True)``), whose loss must be finite and
   whose matmul FLOPs must equal the analytic count;
5. checks the smoke-size fwd on the card against the same function on the
   host (the port's CPU path, which the tests hold against the JAX
   reference);
6. prints one JSON line of per-kernel numbers, then ``{"ok": true, ...}``.

Any failure raises and exits non-zero; without a CUDA device, or without
the package beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def max_abs_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max |ref|), both in float32."""
    d = (out.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item()


def check(name: str, out, ref, tol: float) -> float:
    import torch
    torch.cuda.synchronize()
    err, scale = max_abs_err(out, ref)
    ok = err <= tol and math.isfinite(err)
    print(f"  {name:<44} max_abs_err {err:.3e}  tol {tol:.3e}  "
          f"(max|ref| {scale:.3e})  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} > tol {tol}")
    return err


def kernel_checks(dev, sheet) -> list[dict]:
    """Phase 3: every kernel against its plain version, and its times."""
    import torch
    from repro_torch.kernels.ert import bandwidth, flops, gemm, ops, ref

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return torch.rand(shape, generator=g, device=dev).to(dtype)

    def ms(fn) -> float:
        """Milliseconds per call, timed as characterize times its kernels."""
        return 1e3 * ops.time_launches(fn, dev)

    full = ops.FULL
    rows = []

    # -- triad --------------------------------------------------------------
    print("triad: o = a*s + b (tolerance: 1 ulp of max|ref| in the dtype; "
          "the kernel rounds mul and add separately as the plain version)")
    for dtype, n, reps in ((torch.float32, full.hbm_n, 1),
                           (torch.float32, full.l2_n, 3),
                           (torch.float32, 1_000_003, 1),
                           (torch.bfloat16, full.hbm_n, 1),
                           (torch.bfloat16, 1_000_003, 2)):
        a, b = rand((n,), dtype), rand((n,), dtype)
        out = bandwidth.triad(a, b, reps=reps)
        want = ref.triad_ref(a, b)
        ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8
        check(f"triad {str(dtype)[6:]} n={n} reps={reps}", out, want,
              ulp * want.float().abs().max().item())
    n, reps = full.hbm_n, full.hbm_reps
    a, b = rand((n,), torch.float32), rand((n,), torch.float32)
    err = max_abs_err(bandwidth.triad(a, b), ref.triad_ref(a, b))[0]
    nbytes = bandwidth.triad_bytes(n, 4) * reps
    nflops = bandwidth.triad_flops(n) * reps
    rows.append({
        "name": "triad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ert.cu",
        "replaces": "src/repro/kernels/ert/bandwidth.py:47",
        "shape": f"f32 n={n} reps={reps} (HBM triad of characterize)",
        "max_abs_err": err,
        "ms": ms(lambda: bandwidth.triad(a, b, reps=reps)),
        "plain_ms": ms(lambda: [ref.triad_ref(a, b) for _ in range(reps)]),
        "library_ms": ms(lambda: [torch.add(b, a, alpha=3.0)
                                  for _ in range(reps)]),
        **bound(nbytes, nflops, "f32", sheet)})
    nl, rl = full.l2_n, full.l2_reps
    al, bl = rand((nl,), torch.float32), rand((nl,), torch.float32)
    ms_l2 = ms(lambda: bandwidth.triad(al, bl, reps=rl))
    print(f"  L2-resident triad f32 n={nl} reps={rl}: {ms_l2:.4f} ms = "
          f"{bandwidth.triad_bytes(nl, 4) * rl / ms_l2 / 1e9:.2f} TB/s")
    del a, b, al, bl

    # -- fma_chain ----------------------------------------------------------
    print("fma_chain: (tolerance: f32 n_iters*2^-23 of max|ref| — the kernel "
          "fuses acc*a+b into one rounding, the plain version rounds twice; "
          "bf16: 1 ulp, a rounds to 1.0 so both are exact)")
    for dtype, n, it, ilp in ((torch.float32, full.chain_n, full.chain_iters, 8),
                              (torch.bfloat16, full.chain_n, full.chain_iters, 8),
                              (torch.float32, full.chain_n, full.chain_iters, 1),
                              (torch.float32, 100_001, 64, 2),
                              (torch.float32, 100_001, 64, 4),
                              (torch.bfloat16, 100_001, 64, 4)):
        x = rand((n,), dtype)
        out = flops.fma_chain(x, it, ilp)
        want = ref.fma_chain_ref(x, it, ilp)
        rel = it * 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8
        check(f"fma_chain {str(dtype)[6:]} n={n} iters={it} ilp={ilp}", out,
              want, rel * want.float().abs().max().item())
    n, it = full.chain_n, full.chain_iters
    x = rand((n,), torch.float32)
    err = max_abs_err(flops.fma_chain(x, it, 8), ref.fma_chain_ref(x, it, 8))[0]
    rows.append({
        "name": "fma_chain", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ert.cu",
        "replaces": "src/repro/kernels/ert/flops.py:48",
        "shape": f"f32 n={n} n_iters={it} ilp=8 (f32 ceiling of characterize)",
        "max_abs_err": err,
        "ms": ms(lambda: flops.fma_chain(x, it, 8)),
        "plain_ms": ms(lambda: ref.fma_chain_ref(x, it, 8)),
        "library_ms": None,
        **bound(2.0 * n * 4, flops.fma_flops(n, it, 8), "f32", sheet)})
    del x

    # -- ert_gemm -----------------------------------------------------------
    print("ert_gemm: (tolerance: bf16/f16 out 2^-7 of max|ref| — fp32 sums in "
          "another order, then one rounding to the 8-bit mantissa; f32 out "
          "1e-5 of max|ref|)")
    for dtype, out_dtype, (m, n, k) in (
            (torch.bfloat16, None, (full.gemm_ceiling,) * 3),
            (torch.bfloat16, None, (512, 512, 512)),
            (torch.bfloat16, torch.float32, (256, 384, 96)),
            (torch.float16, None, (1024, 256, 2048)),
            (torch.float32, None, (2048, 2048, 2048)),
            (torch.float32, torch.bfloat16, (128, 256, 64))):
        a, b = rand((m, k), dtype) - 0.5, rand((k, n), dtype) - 0.5
        a, b = a.contiguous(), b.contiguous()
        out = gemm.matmul(a, b, out_dtype=out_dtype)
        want = ref.matmul_ref(a, b, out_dtype)
        od = out_dtype or dtype
        rel = 1e-5 if od == torch.float32 else 2.0 ** -7
        check(f"ert_gemm {str(dtype)[6:]}->{str(od)[6:]} {m}x{n}x{k}", out,
              want, rel * want.float().abs().max().item() + 1e-6)
    s = full.gemm_ceiling
    a = rand((s, s), torch.bfloat16) - 0.5
    b = rand((s, s), torch.bfloat16) - 0.5
    err = max_abs_err(gemm.matmul(a, b), ref.matmul_ref(a, b))[0]
    rows.append({
        "name": "ert_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ert.cu",
        "replaces": "src/repro/kernels/ert/gemm.py:38",
        "shape": f"bf16 {s}x{s}x{s} (tensor-core ceiling of characterize)",
        "max_abs_err": err,
        "ms": ms(lambda: gemm.matmul(a, b)),
        "plain_ms": ms(lambda: ref.matmul_ref(a, b)),
        "library_ms": ms(lambda: torch.matmul(a, b)),
        **bound(3.0 * s * s * 2, gemm.gemm_flops(s, s, s), "bf16", sheet)})
    return rows


def bound(nbytes: float, nflops: float, cls: str, sheet) -> dict:
    """Least time for the work on the datasheet card: the larger of bytes
    over HBM bandwidth and operations over the class's peak."""
    t_bytes = nbytes / sheet.hbm.bytes_per_s
    t_ops = nflops / sheet.peak_for(cls)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this script needs "
                     "a CUDA card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return _fail(f"no src/repro_torch beside {__file__}: run it from a "
                     "checkout of the repository")
    sys.path.insert(0, src)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.core.machine import datasheet_for
    from repro_torch.core.report import machine_table, terms_table
    from repro_torch.core.roofline import roofline_terms
    from repro_torch.device import describe_gpu
    from repro_torch.kernels import build
    from repro_torch.kernels.ert import ops
    from repro_torch.models.transformer import matmul_flops
    from repro_torch.configs.registry import get_config
    from repro_torch.session.session import Session

    # 1. the card ----------------------------------------------------------
    gpu = describe_gpu()
    dev = torch.device("cuda", 0)
    print(f"== 1. card: {gpu['smi']} | capability {gpu['capability']} | "
          f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)")
    sheet = datasheet_for(gpu["name"])
    print(machine_table(sheet))

    # 2. build -------------------------------------------------------------
    print("== 2. build")
    path, secs = build.build("ert", verbose=True)
    print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s")

    # 3. each kernel against its plain version -----------------------------
    print("== 3. kernels against their plain versions (datasheet "
          f"{sheet.name})")
    rows = kernel_checks(dev, sheet)
    for r in rows:
        lib = r["library_ms"]
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        print(f"  {r['name']:<10} {r['shape']}: kernel {r['ms']:.4f} ms | "
              f"plain {r['plain_ms']:.4f} ms | library {lib_s} | bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()

    # 4. the main path, with every launch count at 0 ------------------------
    print("== 4. main path: characterize, ladder, sweep, full-width profile")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device="cuda")
    res = s.characterize(empirical=True)
    print(res.render())
    lad = ops.ladder("cuda")
    for k, v in lad.items():
        print(f"  ladder {k:<32} {v / 1e12:9.2f} TFLOP/s")
    sweep = ops.gemm_size_sweep(device="cuda")
    for size, v in sweep.items():
        print(f"  gemm sweep {size:>5}^3 bf16 {v / 1e12:9.2f} TFLOP/s")
    meas = s.machine
    for name, got, peak in (
            ("f32", meas.peak_flops["f32"], sheet.peak_flops["f32"]),
            ("bf16", meas.peak_flops["bf16"], sheet.peak_flops["bf16"]),
            ("hbm", meas.hbm.bytes_per_s, sheet.hbm.bytes_per_s)):
        print(f"  ceiling {name:<5} measured {got:.4e} vs datasheet "
              f"{peak:.4e} ({100 * got / peak:.1f}%)")
        if not 0 < got <= 1.05 * peak:
            raise AssertionError(f"ceiling {name}: {got} not in (0, 1.05 x "
                                 f"{peak}] — a folded chain or a wrong count")
    # the on-chip level has no datasheet figure (the spec holds a modeled
    # placeholder): hold it above the measured device-memory roof instead
    onchip = meas.vmem
    print(f"  ceiling {onchip.name:<5} measured {onchip.bytes_per_s:.4e} "
          f"(modeled placeholder {sheet.vmem.bytes_per_s:.4e}; must exceed "
          f"the measured hbm {meas.hbm.bytes_per_s:.4e})")
    if not onchip.bytes_per_s > meas.hbm.bytes_per_s:
        raise AssertionError(f"{onchip.name} triad {onchip.bytes_per_s} is "
                             "not above the HBM triad: not cache-resident")

    cfg = get_config("glm4-9b")
    seq, batch = 2048, 2
    print(f"profile glm4-9b full width and depth: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{cfg.param_count() / 1e9:.2f} B params in f32; "
          f"seq {seq} batch {batch} amp O1")
    t0 = time.perf_counter()
    prof = s.profile("glm4-9b", smoke=False, phases=("fwd",), seq=seq,
                     batch=batch, amp="O1", measure=True, iters=5, warmup=2)
    counts = kernels.launch_counts()
    pr = prof.data["fwd"]
    loss = float(pr.output)
    print(f"  fwd loss {loss:.6f} | wall {pr.wall_s * 1e3:.3f} ms (median of "
          f"{pr.measure_iters}) | peak device memory "
          f"{pr.peak_device_bytes / 1e9:.2f} GB | profile call "
          f"{time.perf_counter() - t0:.1f} s")
    if not math.isfinite(loss):
        raise AssertionError(f"fwd loss is not finite: {loss}")
    ana = prof.analyses["fwd"]
    mm = sum(k.total_flops for k in ana.kernels if k.category == "matmul")
    want_mm = matmul_flops(cfg, batch, seq)
    print(f"  matmul FLOPs {mm:.0f} (analytic {want_mm}); total FLOPs "
          f"{ana.total_flops:.0f}; HBM bytes {ana.total_hbm_bytes:.0f}; "
          f"{sum(k.exec_count for k in ana.kernels)} launches in "
          f"{len(ana.kernels)} distinct kernels")
    if mm != want_mm:
        raise AssertionError(f"matmul FLOPs {mm} != analytic {want_mm}")
    print(terms_table({"glm4-9b/fwd vs measured": pr.terms,
                       "glm4-9b/fwd vs datasheet":
                           roofline_terms(ana, sheet)}))
    print(prof.render(charts=1, top_kernels=10))
    print(f"launches on the main path: {json.dumps(counts)}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    del prof, pr
    torch.cuda.empty_cache()

    # 5. the smoke fwd on the card against the host -------------------------
    print("== 5. smoke fwd: card against host (O0 loss rtol 1e-5, logits "
          "atol 1e-4: fp32 sums in another order)")
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import api as M
    from repro_torch.models.params import init
    from torch.utils._pytree import tree_map
    scfg = get_smoke("glm4-9b")
    model = M.build(scfg)
    run = RunConfig(amp="O0")
    gen = torch.Generator().manual_seed(0)
    params = init(model.spec, gen, torch.float32, "cpu")
    batch_c = M.synthetic_batch(scfg, ShapeSpec("s", 32, 4, "train"), 4, gen)
    params_d, batch_d = tree_map(lambda t: t.to(dev), (params, batch_c))
    with torch.no_grad():
        lc = model.forward_fn(params, batch_c, run)
        lg = model.forward_fn(params_d, batch_d, run).cpu()
        loss_c = model.loss_fn(params, batch_c, run)[0].item()
        loss_g = model.loss_fn(params_d, batch_d, run)[0].item()
    check("smoke logits card vs host", lg, lc, 1e-4)
    print(f"  smoke loss card {loss_g:.7f} host {loss_c:.7f}")
    if not math.isclose(loss_g, loss_c, rel_tol=1e-5):
        raise AssertionError(f"smoke loss {loss_g} vs host {loss_c}")

    # 6. results -------------------------------------------------------------
    out = []
    for r in rows:
        out.append({k: r[k] for k in ("name", "route", "source", "replaces")}
                   | {"launches": counts[r["name"]],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu["smi"])
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
