#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``; it builds the
hand-written kernels from ``src/repro_torch/kernels/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the kernel libraries ``ert``, ``fused``, ``flash`` and ``ssd``
   (one ``nvcc`` each, started together; one line of ``ptxas`` register /
   spill use each, the ``wgmma`` GEMM's own, and any ptxas warning);
3. holds each kernel against its plain PyTorch version on the card, at
   the shapes its main path gives it and at odd sizes, checks the
   gradient through each routed op against the plain route, and times
   kernel, plain version and library call beside the datasheet bound
   (the fused, flash and SSD kernels' times replay a CUDA graph of many
   calls, so no host launch overhead is timed; the fused kernels' eager
   back-to-back time is printed beside it), each row with the launch
   config it ran.  The triad is held at 1 ulp at the HBM size of
   ``characterize``, the same ragged by 3 (the bulk-copy kernel's scalar
   tail), its L2 size and odd sizes, and timed in turns with
   ``torch.add``.  ``ert_gemm`` is held at 8192³ in bf16, fp16 and
   bf16→f32, at a shape ragged in M, N and K (1000³) and at the earlier
   odd shapes.  The multi-tensor AdamW launch is held on DeepCAM's 370
   leaves (O1 and O2 moments, in place and not), a 3-element leaf beside
   views at odd offsets, 1,200 small leaves (split into launches of the
   table's capacity) and two dtype groups, each with its launch count,
   and timed on the 370 leaves beside the loop of one-leaf launches and
   ``torch._fused_adamw_`` (eager and host clock, the card's name and
   power limit beside it).  ``fused_layernorm`` is held
   at its dispatch site's shape (4096, 4096) bf16, odd widths up to
   16384, mixed dtypes and rows whose mean (1e3) is large against their
   spread, with its gradient.  The SSD checks hold the
   ``ssd_scan`` kernel to 1e-4 of each (b, h, chunk) block's own max at
   the main shape (chunk 256 and the reference's 128), the reference's
   test shapes, a single chunk, no decay, an underflowing decay and a
   ragged P and N (``SSD_SHAPES``), and its row states the GFLOP its tiles execute and
   its bound on fp32 FMAs beside the one on 3xTF32 tensor cores, which it
   runs on.  The shapes paths g and h give the kernels are held and timed
   too (rows of step 3's table, not of the JSON line): the norms at
   widths 2048 (zamba2) and 3072 (minitron), SwiGLU at (4096, 14336)
   (granite; silu, and the gelu route geglu takes), flash at zamba2's 32
   heads of 64 on 32 KV heads, granite's 32 on 8 and minitron's 24 on 8,
   each beside SDPA, the SSD scan at zamba2's N = 64 and chunk 128, and
   (after path g) the AdamW launch on zamba2's leaves; and the shapes
   path i gives them: flash on a 256-token prefill chunk (1, 256, 2 KV
   heads x 16, 128), the norms at (8, 4096) (a decode tick over 8 slots)
   and (256, 4096), SwiGLU at (8, 13696) and (256, 13696), each beside
   its library call where there is one (``F.rms_norm``, SDPA); and the
   shapes paths k and l give them: flash at granite-moe's 16 heads of 64
   on 8 KV heads, phi-3-vision's 32 heads of 96 (the padded 128-wide
   tile) and seamless's encoder over 256 frames, the norms at width 1024
   (granite-moe, seamless; phi-3's 3072 is minitron's), SwiGLU at
   (4096, 8192) (phi-3), and (after path k) the AdamW launch on
   granite-moe's leaves;
4. drives twelve main paths, each with every launch count set to 0 just
   before it and read just after:
   a. machine characterization (``Session.characterize(empirical=True,
      tuned=False)``,
      the ladder and the GEMM size sweep with ``torch.matmul``'s rate
      beside each size, each ceiling checked against
      1.05x its datasheet value), then the full-width, full-depth
      glm4-9b fwd phase at ``fusion="off"``, whose loss must be finite
      and whose matmul FLOPs must equal the analytic count;
   b. the train step of glm4-9b at full width with the depth cut to 4
      layers (seq 2048, batch 2, AMP O1): its fwd, bwd and opt phases
      profiled with ``measure=True`` under ``fusion="off"`` and
      ``"static"`` (matmul FLOPs must equal the analytic count, 3x it,
      and 0), then 3 steps of ``make_train_step`` under ``"static"``
      with a finite loss each;
   c. the same step at ``attn_impl="flash"`` under ``"static"``: its
      phases profiled (fwd matmul FLOPs must equal the analytic count
      less the QK^T and PV products, the flash records' FLOPs the
      kernel's model, one launch per layer in each fwd pass), 3 steps
      with a finite loss each, one fwd at ``attn_impl="chunked"`` that
      must route to the kernel, then ``Session.record`` into the
      workspace and ``Session.report``, which must read
      the same run back;
   d. mamba2-1.3b at full width (seq 2048, batch 2, AMP O1, ``static``):
      the 48-layer fwd phase at ``ssd_impl="xla"`` and ``"kernel"``
      (finite losses that agree; at ``kernel`` the matmul FLOPs must
      equal ``ssm.matmul_flops``, the ssd_scan records' FLOPs 48x the
      kernel's model, one launch per layer in each fwd pass), the
      48-layer train step at ``kernel`` (fwd, bwd and opt phases, then 3
      steps with a finite loss each), and the bwd phase of both routes
      at 12 layers;
   e. tuning and the measured dispatch (:func:`tuning_path`):
      ``Session.tune()`` of path b's step twice (the fused kernels at
      the points that step launches them at, the ERT kernels through
      the ceiling searches; the second pass all store hits), the tuned
      ceilings against
      path a's and the datasheet, the dispatch search of path b's step
      at ``attn_impl="chunked"`` plus the layernorm site (which launches
      ``fused_layernorm``) twice (the second measures nothing), the
      step's phases at ``fusion="auto"`` under ``REPRO_DISPATCH=frozen``
      beside ``"static"``, and a record that reads back with its
      ``kernel_configs`` and ``dispatch_table`` and whose every fused
      launch found a tuned config;
   f. DeepCAM, the paper's network (:func:`deepcam_path`): stem width 64
      (41,593,491 params in 370 leaves) on (2, 768, 1152, 16) images,
      AMP O1, ``static``, both lowerings (``reference``: every norm in
      fp32; ``fused``: norms folded into the convs): the fwd, bwd and
      opt phases profiled (conv FLOPs must equal the analytic count over
      the 67 convs, 3x it less the stem's input gradient, and 0; one
      ``fused_adamw`` launch per opt call over the 370 leaves, and one
      walk record with their summed bytes and FLOPs; ``reference``'s fwd
      must hold more zero-AI launches and bytes than ``fused``'s; finite
      losses that agree), 3 steps at ``reference``, then a record that
      reads back;
   g. the zamba2-1.2b hybrid (:func:`hybrid_path`) at full width and
      depth (38 Mamba-2 layers, the shared block at 6 sites), seq 2048,
      batch 2, O1, ``static``, SSD kernel, flash: fwd, bwd and opt
      profiled (fwd matmul FLOPs must equal ``hybrid.matmul_flops`` less
      the sites' QKᵀ and PV, the ssd_scan records 38x the kernel's model;
      each fwd pass 38 ssd_scan and 6 flash launches, each opt call one
      ``fused_adamw`` launch), 3 steps with a finite loss, the peak
      memory, one AdamW launch over the model's 19 leaves held against
      the plain chain on every leaf, and the fwd at ``ssd_impl="xla"``
      whose loss must agree with the kernel route's;
   h. the dense family (:func:`dense_family_path`): granite-8b at full
      width cut to 4 layers under remat none, dots and full (equal fwd
      losses, bwd peak memory strictly none > dots > full, each mode's
      recompute in the bwd walk's matmul FLOPs exactly, gradients against
      none's, ``model_flops_ratio``, the bytes one fwd keeps for the bwd
      with dots - full exactly the products against a weight), one fwd
      at flash (G = 4);
      minitron-4b at full width and depth under Adafactor and remat full
      (phases profiled with the 256,000-column unembedding, 3 steps with
      a finite loss, its optimizer state beside AdamW's); and
      mistral-large-123b's fwd walk on meta tensors at full width and
      depth (matmul FLOPs and ``param_count`` exact);
   i. serving (:func:`serve_path`): ``Session.serve`` of glm4-9b at full
      width and depth (40 layers, fp32 weights) under :data:`SERVE_ARGS`
      — 16 Poisson requests, prompts of 64-1024 tokens, 16-64 new tokens,
      8 slots, a paged KV pool of 2048 tokens a slot, 256-token prefill
      chunks, O1, ``static`` —: every request finished by ``length``, the
      allocator clean, flash and the three fused kernels launched exactly
      as often as the walk of each executable times its calls, the
      ``serve/glm4-9b`` record read back by ``Session.report``, TTFT,
      tokens/s and each phase's FLOPs, bytes and share of its bound
      printed; request 0 served again alone, its first-token logits and
      the next 4 tokens' against ``forward_fn`` over the prompt and the
      generated prefix, and its first-token logits under ``static``
      against an engine at ``off``;
   j. decode (:func:`decode_path`): mamba2-1.3b (48 layers) and
      zamba2-1.2b (38 layers, 6 sites) at full width, O0, ``static``: a
      64-token prompt one token at a time through ``decode_fn`` from a
      zero state, each step's logits against ``forward_fn``, and one
      decode step timed at batch 2 and 8 beside its bound (path j runs
      before path i, whose last step runs under ``torch.profiler``);
   k. the MoE family (:func:`moe_path`): granite-moe-1b-a400m's train
      step at full width and depth (24 layers, 32 experts top-8, seq
      2048, batch 2, O1, ``static``, flash: phases against the walk's
      bound, the experts at E·C = 32 x 640 slots in the walk's matmul
      FLOPs, one flash launch a layer a pass, one AdamW launch an opt
      call, 3 steps with their aux loss, the AdamW launch on its leaves),
      ``Session.serve`` of path i's trace on it (16 of 16 done, the
      flash and norm launches equal to the walk's, the first chunk of
      request 0 against ``forward_fn`` over the same routing group,
      :func:`moe_first_token`), and kimi-k2-1t-a32b's fwd walk on meta
      tensors at full width and depth (matmul FLOPs and ``param_count``
      exact);
   l. the VLM and the enc-dec (:func:`multimodal_path`):
      phi-3-vision-4.2b's fwd at full width and depth (576 patch
      embeddings in 2048 positions, batch 2, O1, ``static``, flash) and
      its train step at 4 layers; seamless-m4t-large-v2's train step at
      full width and depth (24 + 24 layers, 256 frames; flash on every
      self-attention, the encoder's too, never on a cross-attention); 16
      of its decode steps against the encoder's memory, each within
      :data:`ENCDEC_DECODE_ATOL` of the forward (O0);
   (paths l and k run after h and before j and i: no profiled window
   before them);
5. checks the smoke-size fwd and one smoke train step (O0, ``static``)
   on the card against the same functions on the host (the port's CPU
   path, which the tests hold against the JAX reference): glm4-9b at
   einsum and flash attention, mamba2-1.3b at the SSD kernel (the
   kernels on the card, their plain versions on the host), DeepCAM in
   both lowerings (fwd of each, a train step of each), zamba2-1.2b at
   the SSD kernel and flash, minitron-4b under Adafactor, granite-8b
   under remat dots, and granite-moe-1b-a400m, kimi-k2-1t-a32b,
   phi-3-vision-4.2b and seamless-m4t-large-v2 at einsum and flash;
6. prints one JSON line of per-kernel numbers, then ``{"ok": true, ...}``.

Every step runs in one workspace, ``build/chip_workspace``, emptied at
the start (``REPRO_WORKSPACE``): until path e tunes, every launch takes
the default config, whatever a tune store elsewhere holds.

Any failure raises and exits non-zero; without a CUDA device, or without
the package beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
LIBRARIES = ("ert", "fused", "flash", "ssd")
ERT_KERNELS = ("triad", "fma_chain", "ert_gemm")
FUSED_KERNELS = ("fused_rmsnorm", "fused_rmsnorm_residual", "fused_swiglu",
                 "fused_adamw")
FLASH_KERNELS = ("flash_attention",)
SSD_KERNELS = ("ssd_scan",)
#: kernels whose main path is path e (the dispatch site's)
TUNE_KERNELS = ("fused_layernorm",)


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


def check_within(name: str, out, ref, tol) -> float:
    """``check`` against an elementwise bound ``tol`` (a tensor that
    broadcasts against ``ref``): every |out - ref| must stay within it.
    Prints the largest error and the largest error over its bound."""
    import torch
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    err = d.max().item()
    worst = (d / tol).max().item()
    ok = worst <= 1.0 and math.isfinite(err)
    print(f"  {name:<44} max_abs_err {err:.3e}  max err/tol {worst:.3f}  "
          f"(max|ref| {ref.float().abs().max().item():.3e})  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: an error reaches {worst} of its "
                             "elementwise bound")
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
                           (torch.float32, full.hbm_n + 3, 1),
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
    # the kernel and torch.add stream at the card's limit within a fraction
    # of a percent: timed in turns (kernel, add, add, kernel), least of each
    kernel_ms, add_ms = in_turns(
        lambda: ms(lambda: bandwidth.triad(a, b, reps=reps)),
        lambda: ms(lambda: [torch.add(b, a, alpha=3.0)
                            for _ in range(reps)]))
    rows.append({
        "name": "triad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ert.cu",
        "replaces": "src/repro/kernels/ert/bandwidth.py:47",
        "shape": f"f32 n={n} reps={reps} (HBM triad of characterize)",
        "config": launch_config("triad", a, (n, reps)),
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": ms(lambda: [ref.triad_ref(a, b) for _ in range(reps)]),
        "library_ms": add_ms,
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
        "config": launch_config("fma_chain", x, (n,), n_iters=it, ilp=8),
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
    s = full.gemm_ceiling
    for dtype, out_dtype, (m, n, k) in (
            (torch.bfloat16, None, (s, s, s)),
            (torch.float16, None, (s, s, s)),
            (torch.bfloat16, torch.float32, (s, s, s)),
            (torch.bfloat16, None, (512, 512, 512)),
            # ragged: M, N and K all off the 128 x 256 x 64 tile
            (torch.bfloat16, None, (1000, 1000, 1000)),
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
    # timed on the operands of the ceiling (the rate depends on the data)
    a, b = ops.gemm_operands(s, s, s, torch.bfloat16, dev)
    want = ref.matmul_ref(a, b)
    err = check(f"ert_gemm bfloat16 {s}x{s}x{s}, ceiling operands",
                gemm.matmul(a, b), want,
                2.0 ** -7 * want.float().abs().max().item())
    del want
    rows.append({
        "name": "ert_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ert.cu",
        "replaces": "src/repro/kernels/ert/gemm.py:38",
        "shape": f"bf16 {s}x{s}x{s} (tensor-core ceiling of characterize)",
        "config": launch_config("ert_gemm", a, (s, s, s)),
        "max_abs_err": err,
        "ms": ms(lambda: gemm.matmul(a, b)),
        "plain_ms": ms(lambda: ref.matmul_ref(a, b)),
        "library_ms": ms(lambda: torch.matmul(a, b)),
        **bound(3.0 * s * s * 2, gemm.gemm_flops(s, s, s), "bf16", sheet)})
    return rows


def in_turns(*timers) -> list[float]:
    """Each timer's least reading over two rounds in turns, forward then
    backward (a, b, b, a), so that neither profits from the card's state
    at one end of the comparison."""
    seen = [[] for _ in timers]
    order = list(range(len(timers)))
    for i in order + order[::-1]:
        seen[i].append(timers[i]())
    return [min(v) for v in seen]


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph and replayed, so no host launch overhead is timed."""
    import torch
    from repro_torch.kernels.ert.ops import time_graph
    dev = torch.device("cuda", torch.cuda.current_device())
    return 1e3 * time_graph(fn, dev, calls=calls, replays=replays)


def launch_config(kernel: str, t, shape, **runtime) -> dict:
    """The config a wrapper called with no ``config`` launches ``kernel``
    with at ``shape`` on ``t`` (the bound tune store's winner, else the
    default), with the run-time arguments the call passes."""
    from repro_torch.kernels import config as kc
    return {**kc.for_launch(kernel, None, t, shape).dict, **runtime}


def shape_row(name: str, shape: str, err: float, kernel, plain, library,
              bnd: dict, config: dict, calls: int = 20) -> dict:
    """A kernel timed at a shape a new path gives it (printed in step 3's
    table, not in the JSON line, which holds one row a kernel):
    ``kernel``, ``plain`` and ``library`` (or None) are callables timed
    through a replayed CUDA graph; ``bnd`` is :func:`bound`'s."""
    return {"name": name, "shape": shape, "max_abs_err": err,
            "config": config, "at_shape": True,
            "ms": graph_ms(kernel, calls=calls),
            "plain_ms": graph_ms(plain, calls=2),
            "library_ms": None if library is None else graph_ms(library,
                                                                calls=calls),
            **bnd}


def rotating(make, k=4):
    """k operand sets, cycled: together larger than the 50 MB L2, so a
    timed launch finds its inputs in HBM as the train step does."""
    import itertools
    sets = [make() for _ in range(k)]
    it = itertools.cycle(sets)
    return sets, lambda: next(it)


def fused_checks(dev, sheet) -> list[dict]:
    """Phase 3 for the fused kernels: each against its plain version at
    the main path's shapes and at odd ones, the gradient through each
    routed op against the plain route, and the times."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ert import ops as ert_ops
    from repro_torch.kernels.fused import norm, ops, swiglu

    g = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def eager_ms(fn) -> float:
        """Milliseconds per call, back to back as the train step calls
        them: host launch overhead included (it hides a kernel shorter
        than the Python call)."""
        return 1e3 * ert_ops.time_launches(fn, dev)

    ms = graph_ms
    def ulp_tol(dtype, ref, f32_ulps: int = 1) -> float:
        # one rounding of an fp32 value that may differ in its last bits
        # (sums in another order, another exp/tanh): 1 ulp of the output
        # dtype at the largest |ref| (an f32 output may take more)
        ulp = 2.0 ** -7 if dtype == bf16 else f32_ulps * 2.0 ** -22
        return ulp * ref.float().abs().max().item() + 1e-30

    rows = []
    eps = 1e-5
    # -- rmsnorm / rmsnorm_residual ------------------------------------------
    print("fused_rmsnorm / fused_rmsnorm_residual: (tolerance: bf16 out 1 "
          "ulp at max|ref| — one rounding at the write of fp32 values that "
          "differ in their last bits; f32 out 8 ulps at max|ref| — the mean "
          "of up to 4097 squares summed in another order moves the "
          "statistics by a few ulps; r = x + h exactly)")
    norm_tol = lambda dt, want: ulp_tol(dt, want, f32_ulps=8)
    stack = torch.rand((4, 4097), generator=g, device=dev) + 0.5
    for (r, d), dt in itertools.product(
            ((4096, 4096), (1, 4097), (4097, 1), (4097, 4097), (1, 1)),
            (bf16, f32)):
        x, h = randn((r, d), dt, 3.0), randn((r, d), dt)
        # d = 4097: a view at a 4-byte offset, so the scalar path runs
        sc = stack[1, :d] if d == 4097 else stack[1, :d].clone()
        want = norm.rmsnorm_ref(x, sc, eps, dt)
        check(f"rmsnorm {str(dt)[6:]} {r}x{d}", norm.fused_rmsnorm(x, sc),
              want, norm_tol(dt, want))
        rr, yy = norm.fused_rmsnorm_residual(x, h, sc)
        r_ref, y_ref = norm.rmsnorm_residual_ref(x, h, sc, eps, dt)
        check(f"rmsnorm_residual r {str(dt)[6:]} {r}x{d}", rr, r_ref, 0.0)
        check(f"rmsnorm_residual y {str(dt)[6:]} {r}x{d}", yy, y_ref,
              norm_tol(dt, y_ref))
    # the per-layer scale of the main path: a view into the (4, d) stack
    # at offset 1·4096·4 B, and bf16 output from f32 statistics
    x = randn((4096, 4096), bf16, 3.0)
    sc = torch.rand((4, 4096), generator=g, device=dev)[1]
    want = norm.rmsnorm_ref(x, sc, eps, f32)
    check("rmsnorm bf16->f32 4096x4096 (scale view)",
          norm.fused_rmsnorm(x, sc, out_dtype=f32), want, norm_tol(f32, want))
    sets, nxt = rotating(lambda: (randn((4096, 4096), bf16, 3.0),
                                  randn((4096, 4096), bf16)))
    x, h = sets[0]
    err = max_abs_err(norm.fused_rmsnorm(x, sc),
                      norm.rmsnorm_ref(x, sc, eps, bf16))[0]
    rows.append({
        "name": "fused_rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused.cu",
        "replaces": "src/repro/kernels/fused/norm.py:55",
        "shape": "bf16 (4096, 4096), f32 scale (ln_attn / ln_f of the main "
                 "path)",
        "config": launch_config("fused_norm", x, (4096, 4096)),
        "max_abs_err": err,
        "ms": ms(lambda: norm.fused_rmsnorm(nxt()[0], sc)),
        "eager_ms": eager_ms(lambda: norm.fused_rmsnorm(nxt()[0], sc)),
        "plain_ms": ms(lambda: norm.rmsnorm_ref(nxt()[0], sc, eps, bf16)),
        # F.rms_norm on a bf16 x with an f32 weight computes in fp32 and
        # returns fp32 (the kernel writes bf16): the yardstick moves 3 of
        # 4 bytes of ours per element, not the same bytes
        "library_ms": ms(lambda: F.rms_norm(nxt()[0], (4096,), sc, eps)),
        **bound(norm.hbm_bytes(4096, 4096, 2), norm.flops(4096, 4096),
                "f32", sheet)})
    sc16 = sc.to(bf16)
    print(f"  F.rms_norm with the scale cast to bf16 (its fused path; not "
          f"the same inputs): "
          f"{ms(lambda: F.rms_norm(nxt()[0], (4096,), sc16, eps)):.4f} ms")
    err = max(max_abs_err(a, b)[0] for a, b in zip(
        norm.fused_rmsnorm_residual(x, h, sc),
        norm.rmsnorm_residual_ref(x, h, sc, eps, bf16)))
    rows.append({
        "name": "fused_rmsnorm_residual", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused.cu",
        "replaces": "src/repro/kernels/fused/norm.py:67",
        "shape": "bf16 (4096, 4096) x and h, f32 scale (ln_mlp of the main "
                 "path)",
        "config": launch_config("fused_norm", x, (4096, 4096)),
        "max_abs_err": err,
        "ms": ms(lambda: norm.fused_rmsnorm_residual(*nxt(), sc)),
        "eager_ms": eager_ms(lambda: norm.fused_rmsnorm_residual(*nxt(),
                                                                 sc)),
        "plain_ms": ms(lambda: norm.rmsnorm_residual_ref(*nxt(), sc, eps,
                                                         bf16)),
        "library_ms": None,
        **bound(norm.hbm_bytes(4096, 4096, 2, residual=True),
                norm.flops(4096, 4096, residual=True), "f32", sheet)})
    del sets, x, h, stack
    # the widths paths g, h, k and l give the norms: zamba2-1.2b (2048),
    # minitron-4b and phi-3-vision-4.2b (3072), granite-moe-1b-a400m and
    # seamless-m4t-large-v2 (1024), 4096 rows (seq 2048 x batch 2)
    for d, who in ((2048, "zamba2-1.2b, path g"),
                   (3072, "minitron-4b, path h; phi-3-vision-4.2b, path l"),
                   (1024, "granite-moe-1b-a400m and seamless-m4t-large-v2, "
                          "paths k and l")):
        sets, nxt = rotating(lambda: (randn((4096, d), bf16, 3.0),
                                      randn((4096, d), bf16)))
        x, h = sets[0]
        sc = torch.rand((4, d), generator=g, device=dev)[1]
        want = norm.rmsnorm_ref(x, sc, eps, bf16)
        err = check(f"rmsnorm bf16 4096x{d} ({who})",
                    norm.fused_rmsnorm(x, sc), want, norm_tol(bf16, want))
        rows.append(shape_row(
            "fused_rmsnorm", f"bf16 (4096, {d}), f32 scale ({who})", err,
            lambda: norm.fused_rmsnorm(nxt()[0], sc),
            lambda: norm.rmsnorm_ref(nxt()[0], sc, eps, bf16),
            lambda: F.rms_norm(nxt()[0], (d,), sc, eps),
            bound(norm.hbm_bytes(4096, d, 2), norm.flops(4096, d), "f32",
                  sheet), launch_config("fused_norm", x, (4096, d))))
        r_ref, y_ref = norm.rmsnorm_residual_ref(x, h, sc, eps, bf16)
        rr, yy = norm.fused_rmsnorm_residual(x, h, sc)
        check(f"rmsnorm_residual r bf16 4096x{d}", rr, r_ref, 0.0)
        err = check(f"rmsnorm_residual y bf16 4096x{d} ({who})", yy, y_ref,
                    norm_tol(bf16, y_ref))
        rows.append(shape_row(
            "fused_rmsnorm_residual", f"bf16 (4096, {d}) x and h ({who})",
            err, lambda: norm.fused_rmsnorm_residual(*nxt(), sc),
            lambda: norm.rmsnorm_residual_ref(*nxt(), sc, eps, bf16), None,
            bound(norm.hbm_bytes(4096, d, 2, residual=True),
                  norm.flops(4096, d, residual=True), "f32", sheet),
            launch_config("fused_norm", x, (4096, d))))
        del sets, x, h, want, r_ref, y_ref, rr, yy

    # -- swiglu ----------------------------------------------------------------
    print("fused_swiglu: (tolerance: 1 ulp of the output dtype at max|ref| "
          "— CUDA's expf/tanhf against ATen's, one rounding at the write)")
    for (r, d), dt, act in itertools.product(
            ((4096, 13_696), (4096, 14_336), (1, 1), (4097, 4097),
             (1, 4097)), (bf16, f32), ("silu", "gelu")):
        a, b = randn((r, d), dt, 2.0), randn((r, d), dt)
        want = swiglu.swiglu_ref(a, b, act, dt)
        check(f"swiglu {act} {str(dt)[6:]} {r}x{d}",
              swiglu.fused_swiglu(a, b, act=act), want, ulp_tol(dt, want))
    sets, nxt = rotating(lambda: (randn((4096, 13_696), bf16, 2.0),
                                  randn((4096, 13_696), bf16)), k=2)
    a, b = sets[0]
    err = max_abs_err(swiglu.fused_swiglu(a, b),
                      swiglu.swiglu_ref(a, b, "silu", bf16))[0]
    rows.append({
        "name": "fused_swiglu", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused.cu",
        "replaces": "src/repro/kernels/fused/swiglu.py:32",
        "shape": "bf16 (4096, 13696), silu (every MLP of the main path)",
        "config": launch_config("fused_swiglu", a, (4096, 13_696)),
        "max_abs_err": err,
        "ms": ms(lambda: swiglu.fused_swiglu(*nxt())),
        "eager_ms": eager_ms(lambda: swiglu.fused_swiglu(*nxt())),
        "plain_ms": ms(lambda: swiglu.swiglu_ref(*nxt(), "silu", bf16)),
        "library_ms": None,
        **bound(swiglu.hbm_bytes(4096, 13_696, 2),
                swiglu.flops(4096, 13_696), "f32", sheet)})
    del sets, a, b
    # granite-8b's MLP (path h): silu, and the gelu route geglu takes
    sets, nxt = rotating(lambda: (randn((4096, 14_336), bf16, 2.0),
                                  randn((4096, 14_336), bf16)), k=2)
    a, b = sets[0]
    for act in ("silu", "gelu"):
        err = max_abs_err(swiglu.fused_swiglu(a, b, act=act),
                          swiglu.swiglu_ref(a, b, act, bf16))[0]
        rows.append(shape_row(
            "fused_swiglu", f"bf16 (4096, 14336), {act} (granite-8b, path "
            f"h{'' if act == 'silu' else '; the geglu route'})", err,
            lambda: swiglu.fused_swiglu(*nxt(), act=act),
            lambda: swiglu.swiglu_ref(*nxt(), act, bf16), None,
            bound(swiglu.hbm_bytes(4096, 14_336, 2),
                  swiglu.flops(4096, 14_336, act), "f32", sheet),
            launch_config("fused_swiglu", a, (4096, 14_336), act=act)))
    del sets, a, b
    # phi-3-vision-4.2b's MLP (path l): silu at d_ff 8192
    sets, nxt = rotating(lambda: (randn((4096, 8192), bf16, 2.0),
                                  randn((4096, 8192), bf16)), k=2)
    a, b = sets[0]
    want = swiglu.swiglu_ref(a, b, "silu", bf16)
    err = check("swiglu silu bf16 4096x8192 (phi-3-vision-4.2b, path l)",
                swiglu.fused_swiglu(a, b), want, ulp_tol(bf16, want))
    rows.append(shape_row(
        "fused_swiglu", "bf16 (4096, 8192), silu (phi-3-vision-4.2b, path "
        "l)", err, lambda: swiglu.fused_swiglu(*nxt()),
        lambda: swiglu.swiglu_ref(*nxt(), "silu", bf16), None,
        bound(swiglu.hbm_bytes(4096, 8192, 2), swiglu.flops(4096, 8192),
              "f32", sheet),
        launch_config("fused_swiglu", a, (4096, 8192))))
    del sets, a, b, want

    rows.append(adamw_checks(dev, sheet, randn))

    # -- gradients through the routed ops ----------------------------------------
    print("gradients through the routed ops against the plain route on the "
          "card (tolerance: 1 ulp of each gradient's dtype at its max — the "
          "fused backward recomputes the same plain math)")
    x = randn((2, 256, 4096), bf16, 3.0)
    h = randn((2, 256, 4096), bf16)
    sc = torch.rand(4096, generator=g, device=dev) + 0.5
    gy = randn((2, 256, 4096), bf16)

    def grads(fn, *inputs, cot):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(out, leaves, cot)

    for name, fused_fn, plain_fn, inputs, cot in (
            ("rmsnorm", lambda a, s: ops.rmsnorm(a, s),
             lambda a, s: norm.rmsnorm_ref(a, s, eps, bf16), (x, sc), (gy,)),
            ("rmsnorm_residual", lambda a, b, s: ops.rmsnorm_residual(a, b, s),
             lambda a, b, s: norm.rmsnorm_residual_ref(a, b, s, eps, bf16),
             (x, h, sc), (gy, gy)),
            ("swiglu", lambda a, b: ops.swiglu(a, b),
             lambda a, b: swiglu.swiglu_ref(a, b, "silu", bf16), (x, h),
             (gy,))):
        for i, (a, w) in enumerate(zip(grads(fused_fn, *inputs, cot=cot),
                                       grads(plain_fn, *inputs, cot=cot))):
            check(f"grad {name} input {i}", a, w, ulp_tol(w.dtype, w))
    return rows


def adamw_checks(dev, sheet, randn) -> dict:
    """Phase 3 for ``fused_adamw``: the one-leaf call against
    ``adamw_ref`` at the main path's shapes and odd ones, the multi-tensor
    launch (:func:`adamw_multi_checks`), and the row of the f32 unembed
    leaf (4096, 151552) in place; ``randn(shape, dtype, scale)`` draws
    the operands on ``dev``."""
    import torch
    from repro_torch.kernels.ert import ops as ert_ops
    from repro_torch.kernels.fused import adamw

    bf16, f32 = torch.bfloat16, torch.float32
    ms = graph_ms

    def eager_ms(fn) -> float:
        return 1e3 * ert_ops.time_launches(fn, dev)

    def ulp_tol(dtype, ref) -> float:
        ulp = 2.0 ** -7 if dtype == bf16 else 2.0 ** -22
        return ulp * ref.float().abs().max().item() + 1e-30

    print("fused_adamw: (tolerance: 1 ulp of each output dtype at max|ref| "
          "— the kernel rounds every operation as the plain version does, "
          "IEEE division and square root, no contraction)")
    hyper = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    bc = torch.tensor([1 - 0.9 ** 3, 1 - 0.95 ** 3], device=dev)

    def leaf(shape, gd, md, pd):
        return (randn(shape, gd), randn(shape, md, 0.1),
                randn(shape, md, 0.01).abs(), randn(shape, pd))

    for shape, dts in (((4, 4096, 13_696), (bf16, bf16, bf16)),
                       ((4, 4096, 13_696), (f32, bf16, bf16)),
                       ((1,), (f32, f32, f32)), ((4097,), (bf16, f32, f32)),
                       ((4097,), (f32, bf16, bf16))):
        gg, m, v, pp = leaf(shape, *dts)
        want = adamw.adamw_ref(gg, m, v, pp, bc, **hyper)
        for tag, got in (("", adamw.fused_adamw(gg, m, v, pp, bc, **hyper)),
                         (" in place", adamw.fused_adamw(
                             gg, m.clone(), v.clone(), pp.clone(), bc,
                             inplace=True, **hyper))):
            for nm, a, w in zip("pmv", got, want):
                check(f"adamw {nm} {shape} g/m/p "
                      f"{'/'.join(str(t)[6:] for t in dts)}{tag}", a, w,
                      ulp_tol(a.dtype, w))
    del gg, m, v, pp, want, got
    torch.cuda.empty_cache()
    multi = adamw_multi_checks(dev, sheet)
    torch.cuda.empty_cache()
    n = 4096 * 151_552
    gg, m, v, pp = leaf((4096, 151_552), f32, f32, f32)
    err = max(max_abs_err(a, w)[0] for a, w in zip(
        adamw.fused_adamw(gg, m, v, pp, bc, **hyper),
        adamw.adamw_ref(gg, m, v, pp, bc, **hyper)))
    torch.cuda.empty_cache()
    steps = [torch.tensor(3.0, device=dev)]
    row = {
        "name": "fused_adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused.cu",
        "replaces": "src/repro/kernels/fused/adamw.py:47",
        "shape": "f32 unembed leaf (4096, 151552), in place as the train "
                 "step runs it",
        "config": launch_config("fused_adamw", pp, (n,)),
        "max_abs_err": err,
        "ms": ms(lambda: adamw.fused_adamw(gg, m, v, pp, bc, inplace=True,
                                           **hyper), calls=5),
        "eager_ms": eager_ms(lambda: adamw.fused_adamw(
            gg, m, v, pp, bc, inplace=True, **hyper)),
        "plain_ms": ms(lambda: adamw.adamw_ref(gg, m, v, pp, bc, **hyper),
                       calls=2),
        # PyTorch's fused AdamW (decoupled decay applied first: the same
        # bytes, a slightly different formula)
        "library_ms": ms(lambda: torch._fused_adamw_(
            [pp], [gg], [m], [v], [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False),
            calls=5),
        **bound(adamw.hbm_bytes(n), adamw.flops(n), "f32", sheet),
        "extra": multi}
    del gg, m, v, pp
    torch.cuda.empty_cache()
    return row



#: small leaves for the multi-tensor AdamW check: more than one launch's
#: table holds (``adamw.CAPACITY``), so the split into launches runs
ADAMW_SPLIT_LEAVES = 1200


def host_ms(fn, calls: int = 20) -> float:
    """Median milliseconds of ``fn`` on the host clock around a call that
    ends in ``torch.cuda.synchronize()`` (after 3 warm calls)."""
    import statistics

    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seen.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(seen)


def adamw_multi_checks(dev, sheet) -> str:
    """Phase 3 for the multi-tensor AdamW launch: ``fused_adamw_multi``
    against ``adamw_ref`` leaf by leaf (tolerance: 1 ulp of each output
    dtype at the leaf's max|ref|, as the one-leaf checks) on DeepCAM's 370
    leaf shapes (``deepcam_spec(64)``; f32 moments as O1 and bf16 as O2,
    in place and not; at O2 also the routed call that is not in place,
    ``ops.adamw_group``), a 3-element leaf beside views at odd element
    offsets into stacked tensors (the vector path after a scalar head, and
    the scalar path where the offsets differ; in place, the stacks outside
    the views must stay as they were), :data:`ADAMW_SPLIT_LEAVES` small
    leaves (the split into launches of ``adamw.CAPACITY``) and a list of
    two dtype groups, each with the launches it must take.  Then the
    370 leaves in place, f32: the one launch, the loop of one-leaf
    launches (``fused_adamw`` per leaf) and ``torch._fused_adamw_`` over
    the same lists, each eagerly between CUDA events (in turns) and on
    the host clock around a synchronized call, the launch and the library
    call also replayed from a CUDA graph (device time alone), beside the
    bound.  Returns that timing line."""
    import torch
    from repro_torch.device import describe_gpu
    from repro_torch.kernels.ert import ops as ert_ops
    from repro_torch.kernels.fused import adamw
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.models import deepcam as DC
    from repro_torch.models.params import leaves

    g = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    hyper = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    bc = torch.tensor([1 - 0.9 ** 3, 1 - 0.95 ** 3], device=dev)
    shapes = [spec.shape for _, spec in leaves(DC.deepcam_spec(64))]

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def make(shapes, gd, md, pd):
        return ([randn(s, gd) for s in shapes],
                [randn(s, md, 0.1) for s in shapes],
                [randn(s, md, 0.01).abs() for s in shapes],
                [randn(s, pd) for s in shapes])

    def hold(name, gs, ms, vs, ps, launches, inplace,
             call=adamw.fused_adamw_multi):
        """Every leaf of the call against adamw_ref; the launches counted."""
        want = [adamw.adamw_ref(*leaf, bc, **hyper)
                for leaf in zip(gs, ms, vs, ps)]
        before = adamw.LAUNCHES
        got = call(gs, ms, vs, ps, bc, inplace=inplace, **hyper)
        took = adamw.LAUNCHES - before
        if inplace and not all(a is b for a, b in zip(got[0], ps)):
            raise AssertionError(f"{name}: in place returned new tensors")
        for k, nm in enumerate("pmv"):
            ulp = [(2.0 ** -7 if w[k].dtype == bf16 else 2.0 ** -22)
                   * w[k].float().abs().max() + 1e-30 for w in want]
            check_within(
                f"adamw multi {nm} {name}{' in place' if inplace else ''}",
                torch.cat([t.float().reshape(-1) for t in got[k]]),
                torch.cat([w[k].float().reshape(-1) for w in want]),
                torch.cat([u.expand(w[k].numel())
                           for u, w in zip(ulp, want)]))
        print(f"  {'':<44} {len(ps)} leaves, {took} launches")
        if took != launches:
            raise AssertionError(f"{name}: {took} launches, not {launches}")

    print(f"fused_adamw_multi: (tolerance: 1 ulp of each output dtype at the "
          f"leaf's max|ref|, as the one-leaf checks; launches per call as "
          f"the dtype groups and the table's {adamw.CAPACITY} leaves say)")
    for tag, dts in (("deepcam O1 f32", (f32, f32, f32)),
                     ("deepcam O2 bf16 moments", (f32, bf16, bf16))):
        lists = make(shapes, *dts)
        hold(tag, *lists, 1, False)
        hold(tag, lists[0], *(list(t.clone() for t in ts)
                              for ts in lists[1:]), 1, True)
    # the routed call that is not in place (repro_torch::adamw_multi: the
    # kernel writes new tensors through its output pointers)
    hold("deepcam O2 bf16 moments routed", *lists, 1, False,
         call=fops.adamw_group)
    del lists

    # views at odd element offsets into one stack per operand, beside a
    # 3-element leaf: (offset of g, offset of m/v/p, n); g at another
    # offset than m/v/p takes the scalar path
    spans = ((4101, 4101, 4097), (6, 6, 10), (16_390, 20_001, 9000),
             (30_001, 30_001, 1))
    stacks = [randn(40_000, f32) for _ in range(2)] + [
        randn(40_000, f32, 0.01).abs(), randn(40_000, f32)]

    def views(st):
        vw = [[st[0][a:a + n] for a, _, n in spans]]
        vw += [[t[b:b + n] for _, b, n in spans] for t in st[1:]]
        return [t + v for t, v in zip(make([(3,)], f32, f32, f32), vw)]

    hold("3-element leaf and odd-offset views", *views(stacks), 1, False)
    live = [t.clone() for t in stacks]
    hold("3-element leaf and odd-offset views", *views(live), 1, True)
    torch.cuda.synchronize()
    outside = torch.ones(40_000, dtype=torch.bool, device=dev)
    for _, b, n in spans:
        outside[b:b + n] = False
    for k in (1, 2, 3):
        if not torch.equal(live[k][outside], stacks[k][outside]):
            raise AssertionError("in place over views wrote outside them")

    sizes = torch.randint(1, 3000, (ADAMW_SPLIT_LEAVES,),
                          generator=torch.Generator().manual_seed(6))
    lists = make([(int(n),) for n in sizes], f32, f32, f32)
    hold(f"{ADAMW_SPLIT_LEAVES} small leaves", *lists,
         -(-ADAMW_SPLIT_LEAVES // adamw.CAPACITY), False)
    two = [make(shapes[:6], f32, f32, f32), make(shapes[6:12], f32, bf16,
                                                  bf16)]
    mixed = [[t for pair in zip(a, b) for t in pair]
             for a, b in zip(*two)]
    hold("two dtype groups, interleaved", *mixed, 2, False)
    del lists, two, mixed

    # the times, on the 370 leaves in place as the opt phase runs them
    gs, ms, vs, ps = make(shapes, f32, f32, f32)
    steps = [torch.tensor(3.0, device=dev) for _ in ps]
    n = sum(p.numel() for p in ps)

    def launch():
        adamw.fused_adamw_multi(gs, ms, vs, ps, bc, inplace=True, **hyper)

    def loop():
        for leaf in zip(gs, ms, vs, ps):
            adamw.fused_adamw(*leaf, bc, inplace=True, **hyper)

    def library():
        # PyTorch's multi-tensor fused AdamW (decoupled decay applied
        # first: the same bytes, a slightly different formula)
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=3e-4, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False)

    def events(fn):
        return lambda: 1e3 * ert_ops.time_launches(fn, dev)

    ev = dict(zip(("launch", "loop", "library"),
                  in_turns(events(launch), events(loop), events(library))))
    host = {name: host_ms(fn) for name, fn in (
        ("launch", launch), ("loop", loop), ("library", library))}
    graph = {"launch": graph_ms(launch, calls=5),
             "library": graph_ms(library, calls=5)}
    bd = bound(sum(adamw.hbm_bytes(p.numel()) for p in ps), adamw.flops(n),
               "f32", sheet)
    line = (f"370 DeepCAM leaves ({n} params, f32, in place; "
            f"{describe_gpu()['smi']}): one launch {ev['launch']:.4f} ms "
            f"eager (events), {host['launch']:.4f} ms host clock, "
            f"{graph['launch']:.4f} ms graph | loop of one-leaf launches "
            f"{ev['loop']:.4f} ms eager, {host['loop']:.4f} ms host | "
            f"torch._fused_adamw_ {ev['library']:.4f} ms eager, "
            f"{host['library']:.4f} ms host, {graph['library']:.4f} ms "
            f"graph | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    print(f"  {line}")
    del gs, ms, vs, ps
    return line


def layernorm_checks(dev, sheet) -> list[dict]:
    """Phase 3 for ``fused_layernorm``: the kernel against ``layernorm_ref``
    at the dispatch site's shape (4096, 4096) bf16 and at odd ones, the
    gradient through ``repro_torch::layernorm`` against the plain route,
    and the times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused import norm, ops

    g = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    eps = 1e-5

    def randn(shape, dtype, scale=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                + mean).to(dtype)

    def tol(out_dtype, want, x=None, scale=None):
        """1 ulp of a bf16 output at max|ref|, 8 of an f32 one (sums in
        another order); for a row with a large mean, plus 8 fp32 ulps of
        max|x| carried through the normalization (|scale| / σ): any two
        orders of the fp32 statistics differ by that much there."""
        ulp = 2.0 ** -7 if out_dtype == bf16 else 8 * 2.0 ** -22
        t = ulp * want.float().abs().max().item()
        if x is not None:
            xf = x.float()
            sigma = xf.var(dim=-1, correction=0).min().sqrt().item()
            t += (8 * torch.finfo(f32).eps / 2 * xf.abs().max().item()
                  * scale.float().abs().max().item() / sigma)
        return t

    print("fused_layernorm: (tolerance: bf16 out 1 ulp at max|ref| — one "
          "rounding at the write of fp32 values that differ in their last "
          "bits; f32 out 8 ulps at max|ref| — the mean and variance of up to "
          "16384 values summed in another order; rows with mean 1e3 and "
          "spread 1 add 8 fp32 ulps of max|x| times |scale|/σ, the "
          "statistics' own rounding, which E[x²] − μ² would miss by 4-10% "
          "of max|ref|)")
    stack = torch.rand((4, 16_385), generator=g, device=dev) + 0.5
    cases = (((4096, 4096), bf16, bf16, f32, "scale/bias f32"),
             ((4097, 4095), bf16, bf16, f32, "scalar path"),
             ((3001, 1000), f32, f32, f32, ""),
             ((333, 16_384), bf16, bf16, f32, "64 KiB of shared memory"),
             ((4096, 4096), f32, bf16, f32, "f32 in, bf16 out"),
             ((4096, 4096), bf16, bf16, bf16, "scale/bias bf16"),
             ((1, 8), f32, f32, f32, "one row"),
             ((5000, 1), f32, f32, f32, "d = 1"))
    for (r, d), dt, odt, sdt, what in cases:
        x = randn((r, d), dt, 3.0)
        # fresh (16-byte aligned) copies: the vector path where d allows
        sc, bi = stack[1, :d].to(sdt).clone(), stack[2, :d].to(sdt) - 1.0
        want = norm.layernorm_ref(x, sc, bi, eps, odt)
        check(f"layernorm {str(dt)[6:]}->{str(odt)[6:]} {r}x{d} {what}",
              norm.fused_layernorm(x, sc, bi, out_dtype=odt), want,
              tol(odt, want))
    # scale and bias as views at a 4-byte offset: the scalar path
    x = randn((4096, 4096), bf16, 3.0)
    sc, bi = stack[1, 1:4097], stack[2, 3:4099]
    want = norm.layernorm_ref(x, sc, bi, eps, bf16)
    check("layernorm bf16 4096x4096 scale/bias views", norm.fused_layernorm(
        x, sc, bi), want, tol(bf16, want))
    for dt in (f32, bf16):
        x = randn((512, 4096), dt, 1.0, mean=1e3)
        sc, bi = stack[1, :4096].clone(), stack[2, :4096].clone()
        want = norm.layernorm_ref(x, sc, bi, eps, dt)
        check(f"layernorm {str(dt)[6:]} 512x4096 mean 1e3 spread 1",
              norm.fused_layernorm(x, sc, bi), want, tol(dt, want, x, sc))

    print("gradient through repro_torch::layernorm against the plain route "
          "(tolerance: 1 ulp of each gradient's dtype at its max — the "
          "backward recomputes the same plain math)")
    x = randn((2, 256, 4096), bf16, 3.0)
    sc, bi = stack[1, :4096].clone(), stack[2, :4096] - 1.0
    gy = randn((2, 256, 4096), bf16)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, sc, bi)]
        return torch.autograd.grad(fn(*leaves), leaves, gy)

    for i, (a, w) in enumerate(zip(
            grads(lambda a, s, b: ops.layernorm(a, s, b, eps=eps)),
            grads(lambda a, s, b: norm.layernorm_ref(a, s, b, eps, bf16)))):
        ulp = 2.0 ** -7 if w.dtype == bf16 else 2.0 ** -22
        check(f"grad layernorm input {i}", a, w,
              ulp * w.float().abs().max().item())

    sc, bi = stack[1, :4096].clone(), stack[2, :4096].clone()
    sets, nxt = rotating(lambda: randn((4096, 4096), bf16, 3.0))
    x = sets[0]
    err = max_abs_err(norm.fused_layernorm(x, sc, bi),
                      norm.layernorm_ref(x, sc, bi, eps, bf16))[0]

    # ATen's layer_norm takes its weight and bias in the input's dtype:
    # bf16 copies of the scale and bias (16 KB against 67 MB of rows, the
    # same bytes; they differ from ours only in those two roundings)
    sc16, bi16 = sc.to(bf16), bi.to(bf16)

    def library(x):
        return F.layer_norm(x, (4096,), sc16, bi16, eps)

    row = {
        "name": "fused_layernorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused.cu",
        "replaces": "src/repro/kernels/fused/norm.py:81",
        "shape": "bf16 (4096, 4096), f32 scale and bias (the layernorm "
                 "dispatch site of path e)",
        "config": launch_config("fused_norm", x, (4096, 4096)),
        "max_abs_err": err,
        "ms": graph_ms(lambda: norm.fused_layernorm(nxt(), sc, bi)),
        "plain_ms": graph_ms(lambda: norm.layernorm_ref(nxt(), sc, bi, eps,
                                                        bf16)),
        "library_ms": graph_ms(lambda: library(nxt())),
        **bound(norm.hbm_bytes(4096, 4096, 2, bias=True),
                norm.layernorm_flops(4096, 4096), "f32", sheet)}
    del sets, x, stack
    torch.cuda.empty_cache()
    return [row]


def flash_checks(dev, sheet) -> list[dict]:
    """Phase 3 for flash attention: the kernel against its plain version
    at the main path's shape and at odd ones (both layouts), the gradient
    through the routed op against the plain route, and the times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import config as kc
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref

    g = torch.Generator(device=dev).manual_seed(2)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def gqa(b, s, kv, grp, hd, dt, sk=None):
        sk = sk or s
        return (randn((b, s, kv, grp, hd), dt), randn((b, sk, kv, hd), dt),
                randn((b, sk, kv, hd), dt))

    print("flash_attention: (tolerance, elementwise, "
          "ref.kernel_tolerance: fp32 1e-5 of max|ref| — the same fp32 math "
          "summed in another order; bf16/fp16 s * (|ref| + the row's "
          "max|ref| over head_dim), s = 2^-7 / 2^-10 the dtype's relative "
          "spacing — the output may round to a neighbour, and P is rounded "
          "to the input dtype for the tensor-core PV product; per row, so "
          "a late query row's small output is held to its own scale)")
    main = (2, 2048, 2, 16, 128)
    # (q shape (B, S, KV, G, hd), dtype, causal, Sk when not S); each check
    # prints the kernel that ran it (kernel.route: the library's own choice)
    for shape, dt, causal, *sk in ((main, bf16, True),
                                   (main, f16, True),
                                   (main, bf16, False),
                                   ((1, 4096, 2, 16, 128), bf16, True),
                                   ((2, 300, 2, 3, 128), bf16, True, 700),
                                   ((1, 1000, 1, 1, 64), f32, True),
                                   ((1, 1000, 1, 1, 64), bf16, True),
                                   ((1, 1000, 2, 2, 128), f16, True),
                                   ((2, 1000, 2, 3, 64), f32, False),
                                   ((4, 32, 1, 4, 16), bf16, True),
                                   ((4, 32, 1, 4, 16), f32, True),
                                   ((1, 77, 2, 2, 8), bf16, True),
                                   ((1, 130, 1, 4, 24), f16, True),
                                   ((1, 200, 1, 2, 72), bf16, False),
                                   ((1, 129, 2, 1, 136), bf16, True),
                                   ((1, 300, 1, 2, 256), bf16, True),
                                   ((1, 300, 1, 2, 256), f32, True),
                                   ((2, 1, 1, 2, 16), bf16, True)):
        q, k, v = gqa(*shape, dt, *sk)
        want = ops._ref_gqa(q, k, v, causal)
        check_within(f"flash[{fk.route(shape[-1], dt)}] "
                     f"{'x'.join(map(str, shape))}"
                     f"{f' sk={sk[0]}' if sk else ''} {str(dt)[6:]} "
                     f"causal={causal}", fk.flash_attention_grouped(
                         q, k, v, causal=causal), want,
                     ref.kernel_tolerance(want))
        del q, k, v, want
    if fk.route(main[-1], bf16) != "wgmma":
        raise AssertionError(f"the bf16 main shape ran the "
                             f"{fk.route(main[-1], bf16)} kernel, not wgmma")
    for dt, causal in ((bf16, False), (bf16, True), (f32, True)):
        q, k, v = randn((6, 100, 64), dt), randn((6, 257, 64), dt), \
            randn((6, 257, 64), dt)
        want = ref.attention_ref(q, k, v, causal=causal)
        check_within(f"flash (BH, S, hd) sq=100 sk=257 {str(dt)[6:]} "
                     f"causal={causal}", fk.flash_attention(
                         q, k, v, causal=causal), want,
                     ref.kernel_tolerance(want))

    print("gradient through the routed flash op against the plain route "
          "(tolerance: 1 ulp of each gradient's dtype at its max — the "
          "backward recomputes the same plain math)")
    q, k, v = gqa(1, 512, 2, 4, 128, bf16)
    gy = randn(q.shape, bf16)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, gy)

    for i, (a, w) in enumerate(zip(
            grads(ops.flash_attention_gqa),
            grads(lambda a, b, c: ops._ref_gqa(a, b, c, True)))):
        check(f"grad flash_attention input {i}", a, w,
              2.0 ** -7 * w.float().abs().max().item())
    del q, k, v, gy

    b, s, kv, grp, hd = main
    sets, nxt = rotating(lambda: gqa(*main, bf16), k=2)
    q, k, v = sets[0]
    want = ops._ref_gqa(q, k, v, True)
    err = check_within("flash main shape, timed operands",
                       fk.flash_attention_grouped(q, k, v), want,
                       ref.kernel_tolerance(want))
    del want

    def sdpa(q, k, v):
        # the library yardstick in its own (B, H, S, hd) layout; the
        # transposes are views, and enable_gqa reads the shared KV heads
        return F.scaled_dot_product_attention(
            q.flatten(2, 3).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), is_causal=True, enable_gqa=True)

    flop = fk.flops(b * kv * grp, s, s, hd)
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
        "shape": "bf16 q (2, 2048, 2, 16, 128), k/v (2, 2048, 2, 128), "
                 "causal (every attention of path c)",
        # compiled tiles: the wrapper reads no tune store
        "config": kc.resolve("flash_attention", None).dict,
        "max_abs_err": err,
        "ms": graph_ms(lambda: fk.flash_attention_grouped(*nxt())),
        "plain_ms": graph_ms(lambda: ops._ref_gqa(*nxt(), True), calls=2),
        "library_ms": graph_ms(lambda: sdpa(*nxt())),
        **bound(fk.hbm_bytes(b * kv * grp, s, s, hd, 2), flop, "bf16",
                sheet)}
    row["extra"] = (f"{fk.route(hd, bf16)} kernel, "
                    f"{flop / row['ms'] / 1e9:.1f} TFLOP/s, "
                    f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound, "
                    f"{row['ms'] / row['library_ms']:.3f}x SDPA")
    del sets, q, k, v
    rows = [row]
    # the heads paths g and h give it: zamba2-1.2b's 32 heads of 64 on 32
    # KV heads (G = 1), granite-8b's 32 on 8 (G = 4), minitron-4b's 24 on
    # 8 (G = 3); seq 2048, batch 2, causal
    # and paths k and l: granite-moe-1b-a400m's 16 on 8 (G = 2, hd 64),
    # phi-3-vision-4.2b's 32 heads of 96 (G = 1: the padded 128-wide tile),
    # seamless-m4t-large-v2's encoder over 256 frames (16 heads of 64)
    for shape, who in (((2, 2048, 32, 1, 64), "zamba2-1.2b, path g"),
                       ((2, 2048, 8, 4, 128), "granite-8b, path h"),
                       ((2, 2048, 8, 3, 128), "minitron-4b, path h"),
                       ((2, 2048, 8, 2, 64), "granite-moe-1b-a400m, path k"),
                       ((2, 2048, 32, 1, 96), "phi-3-vision-4.2b, path l"),
                       ((2, 256, 16, 1, 64),
                        "seamless-m4t-large-v2's encoder, path l")):
        b, s_, kv, grp, hd = shape
        sets, nxt = rotating(lambda: gqa(*shape, bf16), k=2)
        q, k, v = sets[0]
        want = ops._ref_gqa(q, k, v, True)
        err = check_within(f"flash[{fk.route(hd, bf16)}] {who} "
                           f"{'x'.join(map(str, shape))} bf16 causal",
                           fk.flash_attention_grouped(q, k, v), want,
                           ref.kernel_tolerance(want))
        del want, q, k, v
        flop = fk.flops(b * kv * grp, s_, s_, hd)
        r = shape_row(
            "flash_attention", f"bf16 q {shape}, causal ({who})", err,
            lambda: fk.flash_attention_grouped(*nxt()),
            lambda: ops._ref_gqa(*nxt(), True), lambda: sdpa(*nxt()),
            bound(fk.hbm_bytes(b * kv * grp, s_, s_, hd, 2), flop, "bf16",
                  sheet), kc.resolve("flash_attention", None).dict)
        r["extra"] = (f"{fk.route(hd, bf16)} kernel, "
                      f"{flop / r['ms'] / 1e9:.1f} TFLOP/s, "
                      f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
                      f"{r['ms'] / r['library_ms']:.3f}x SDPA")
        rows.append(r)
        del sets
    torch.cuda.empty_cache()
    return rows


#: the SSD kernel's checks, ((B, H, S, P, N, chunk), a_kind): the main
#: path's shape at its chunk (256) and the reference's (128), zamba2's,
#: the reference's test shapes, a single chunk, no decay and an underflowing
#: decay (``tools/ssd_check.py`` checks the same)
SSD_SHAPES = (((2, 64, 2048, 64, 128, 256), "random"),
              ((2, 64, 2048, 64, 128, 128), "random"),
              # zamba2-1.2b's (path g): N = 64, the reference's chunk 128
              ((2, 64, 2048, 64, 64, 128), "random"),
              ((2, 3, 256, 16, 8, 64), "random"),
              ((1, 2, 128, 32, 16, 32), "random"),
              ((2, 1, 64, 8, 8, 64), "random"),
              ((2, 4, 256, 64, 128, 256), "random"),
              ((1, 4, 1024, 64, 128, 256), "zero"),
              ((1, 4, 1024, 64, 128, 256), "underflow"),
              # P % 4 != 0 takes the kernels' scalar loads of x and y, and
              # N % 8 == 4 the zero-padded last k-step of the state products
              ((1, 2, 192, 30, 20, 96), "random"))
#: the dense TF32 peak of an H100 SXM (NVIDIA's datasheet), FLOP/s: the
#: SSD kernel's products run on the tensor cores in TF32 (three a product)
TF32_PEAK = 494.7e12


def ssd_operands(g, dev, b, h, s, p, n, layout="kernel", a_kind="random"):
    """x, a, B, C as the reference's tests draw them: x, B, C at 0.5,
    a = -0.1 |N(0, 1)|; ``a_kind`` "zero" (no decay) or "underflow"
    (a <= -200: every decay but the diagonal's underflows to 0)."""
    import torch

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    xs, as_ = (((b, h, s, p), (b, h, s)) if layout == "kernel"
               else ((b, s, h, p), (b, s, h)))
    a = -randn(as_).abs() * 0.1
    if a_kind == "zero":
        a = torch.zeros_like(a)
    elif a_kind == "underflow":
        a = a * 100.0 - 200.0
    return randn(xs, 0.5), a, randn((b, s, n), 0.5), randn((b, s, n), 0.5)


def ssd_checks(dev, sheet) -> list[dict]:
    """Phase 3 for the SSD scan: the kernel against its plain version at
    :data:`SSD_SHAPES`, each (b, h, chunk) block held to its own scale; the
    gradient through the routed op against the plain route; and the times
    beside the bounds on FMAs and on the tensor cores."""
    import torch
    from repro_torch.kernels import config as kc
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models.ssm import ssd_chunked

    g = torch.Generator(device=dev).manual_seed(3)

    def operands(*dims, **kw):
        return ssd_operands(g, dev, *dims, **kw)

    print(f"ssd_scan: (tolerance, per (b, h, chunk) block, "
          f"ref.kernel_tolerance: {ref.REL_TOL:g} of the block's own "
          f"max|ref| — fp32 sums in another order, each product in 3xTF32; "
          f"per block, so a wrong state carried into a late chunk cannot "
          f"hide under another block's larger outputs)")
    main = SSD_SHAPES[0][0]
    for (b, h, s, p, n, q), a_kind in SSD_SHAPES:
        x, a, bm, cm = operands(b, h, s, p, n, a_kind=a_kind)
        want = ref.ssd_ref(x, a, bm, cm, chunk=q)
        check_within(f"ssd {b}x{h}x{s}x{p} N={n} Q={q} a={a_kind}",
                     sk.ssd_scan(x, a, bm, cm, chunk=q), want,
                     ref.kernel_tolerance(want, q))
    print("gradient through the routed ssd_scan op against the xla route "
          "(tolerance: 1e-5 of each gradient's max — the backward "
          "recomputes the same plain math)")
    xh, a, bm, cm = operands(1, 4, 256, 64, 128, layout="model")
    gy = torch.randn(xh.shape, generator=g, device=dev)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (xh, a, bm, cm)]
        return torch.autograd.grad(fn(*leaves), leaves, gy)

    for i, (got, w) in enumerate(zip(
            grads(lambda *t: ops.ssd_scan_model_layout(*t, 64)),
            grads(lambda *t: ssd_chunked(*t, 64)))):
        check(f"grad ssd_scan input {i}", got, w,
              1e-5 * w.float().abs().max().item())
    del xh, a, bm, cm, gy

    b, h, s, p, n, q = main
    sets, nxt = rotating(lambda: operands(b, h, s, p, n, layout="model"),
                         k=2)
    xh, a, bm, cm = sets[0]
    want = ssd_chunked(xh, a, bm, cm, q)
    tol = ref.kernel_tolerance(want.transpose(1, 2), q).transpose(1, 2)
    err = check_within("ssd main shape, model layout, timed operands",
                       sk.ssd_scan_model(xh, a, bm, cm, chunk=q), want, tol)
    del want, tol
    # the work the scan needs (causal pairs, C·Bᵀ shared by the heads), not
    # the reference's coarser ``flops`` model; on the tensor cores each
    # product runs three times (3xTF32), against the dense TF32 peak
    nbytes = sk.hbm_bytes(b, h, s, p, n)
    need = sk.needed_flops(b, h, s, p, n, q)
    fma = bound(nbytes, need, "f32", sheet)
    tc = bound(nbytes, 3 * need, "tf32", sheet, peak=TF32_PEAK)
    executed = sk.executed_flops(b, h, s, p, n, q)
    row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:68",
        "shape": "f32 xh (2, 2048, 64, 64), a (2, 2048, 64), B/C (2, 2048, "
                 "128), chunk 256 (every SSD scan of path d)",
        # the model passes the chunk; the wrapper reads no tune store
        "config": kc.resolve("ssd_scan", None, chunk=q).dict,
        "max_abs_err": err,
        "ms": graph_ms(lambda: sk.ssd_scan_model(*nxt(), chunk=q)),
        "plain_ms": graph_ms(lambda: ssd_chunked(*nxt(), q), calls=2),
        # no single PyTorch call computes the chunked SSD scan
        "library_ms": None,
        "extra": (f"executed {executed / 1e9:.4f} GFLOP ({3 * executed / 1e9:.4f}"
                  f" on the tensor cores), needed {need / 1e9:.4f}; bound on "
                  f"3xTF32 {tc['bound_ms']:.4f} ms ({tc['bound_by']}), on "
                  f"fp32 FMAs {fma['bound_ms']:.4f} ms ({fma['bound_by']})"),
        **tc}
    del sets, xh, a, bm, cm
    rows = [row]
    # zamba2-1.2b's scan (path g): N = 64, chunk 128
    b, h, s, p, n, q = SSD_SHAPES[2][0]
    sets, nxt = rotating(lambda: operands(b, h, s, p, n, layout="model"),
                         k=2)
    xh, a, bm, cm = sets[0]
    want = ssd_chunked(xh, a, bm, cm, q)
    tol = ref.kernel_tolerance(want.transpose(1, 2), q).transpose(1, 2)
    err = check_within("ssd zamba2-1.2b shape, model layout, timed operands",
                       sk.ssd_scan_model(xh, a, bm, cm, chunk=q), want, tol)
    del want, tol
    nbytes = sk.hbm_bytes(b, h, s, p, n)
    need = sk.needed_flops(b, h, s, p, n, q)
    fma = bound(nbytes, need, "f32", sheet)
    r = shape_row(
        "ssd_scan", f"f32 xh ({b}, {s}, {h}, {p}), B/C ({b}, {s}, {n}), "
        f"chunk {q} (zamba2-1.2b, path g)", err,
        lambda: sk.ssd_scan_model(*nxt(), chunk=q),
        lambda: ssd_chunked(*nxt(), q), None,
        bound(nbytes, 3 * need, "tf32", sheet, peak=TF32_PEAK),
        kc.resolve("ssd_scan", None, chunk=q).dict)
    r["extra"] = (f"needed {need / 1e9:.4f} GFLOP; bound on fp32 FMAs "
                  f"{fma['bound_ms']:.4f} ms ({fma['bound_by']})")
    rows.append(r)
    del sets, xh, a, bm, cm
    torch.cuda.empty_cache()
    return rows


def bound(nbytes: float, nflops: float, cls: str, sheet,
          peak: float | None = None) -> dict:
    """Least time for the work on the datasheet card: the larger of bytes
    over HBM bandwidth and operations over the class's peak (``peak`` in
    FLOP/s for a class the machine spec does not hold, such as TF32: its
    ``peak_for`` would fall back to the bf16 peak)."""
    t_bytes = nbytes / sheet.hbm.bytes_per_s
    t_ops = nflops / (sheet.peak_for(cls) if peak is None else peak)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_summary(label: str, ph: str, prof, sheet,
                  custom: str = "flash_attention",
                  dense: str = "matmul") -> tuple[float, float]:
    """Print one measured phase of a profile: wall against the datasheet
    bound, peak memory, launches, zero-AI launches, FLOPs and bytes;
    returns (FLOPs of the ``dense`` category — matmul, or conv —, FLOPs of
    the ``custom`` kernel's records)."""
    from repro_torch.core.roofline import roofline_terms
    pr, ana = prof.data[ph], prof.analyses[ph]
    mm = sum(k.total_flops for k in ana.kernels if k.category == dense)
    fl = sum(k.total_flops for k in ana.kernels if k.opcode == custom)
    z_inv, z_bytes = ana.zero_ai_census()["zero-AI"]
    bound_ms = 1e3 * roofline_terms(ana, sheet).bound_overlap_s
    print(f"  {label:<6} {ph}: wall {pr.wall_s * 1e3:.3f} ms (median of "
          f"{pr.measure_iters}) | datasheet bound {bound_ms:.3f} ms | peak "
          f"device memory {pr.peak_device_bytes / 1e9:.2f} GB | launches "
          f"{sum(k.exec_count for k in ana.kernels)}, zero-AI {z_inv} "
          f"({z_bytes / 1e9:.3f} GB) | {dense} FLOPs {mm:.0f} | {custom} "
          f"FLOPs {fl:.0f} | HBM bytes {ana.total_hbm_bytes:.0f}")
    return mm, fl


def check_adamw_walk(label: str, opt, numels, launched: int, calls: int,
                     cuda: bool) -> None:
    """An opt phase at O1 whose leaves all route to the fused AdamW
    kernel: its walk (``opt``) must hold one ``adamw_multi_`` record whose
    bytes and FLOPs equal the sums of the one-leaf models
    (``adamw.hbm_bytes`` and ``adamw.flops`` of each leaf, all f32), and
    on the card the kernel must have launched once (one dtype group) in
    each of its ``calls`` opt calls."""
    from repro_torch.kernels.fused import adamw
    recs = [k for k in opt.kernels if k.opcode == "adamw_multi_"]
    want_bytes = sum(adamw.hbm_bytes(n) for n in numels)
    want_flops = sum(adamw.flops(n) for n in numels)
    got = [(k.exec_count, k.hbm_bytes, k.flops) for k in recs]
    print(f"  {label}: fused_adamw {launched} launches ({calls} opt calls, "
          f"{len(numels)} leaves in one group); walk {got} (exec count, "
          f"bytes, FLOPs) vs the per-leaf sums {want_bytes:.0f} B, "
          f"{want_flops:.0f} FLOPs")
    if got != [(1, want_bytes, want_flops)] or (cuda and launched != calls):
        raise AssertionError(f"{label}: fused_adamw launched {launched} "
                             f"times in {calls} opt calls; walk {got}")


def train_path(cfg, sheet, *, device: str = "cuda", layers: int = 4,
               seq: int = 2048, batch: int = 2, smoke: bool = False) -> dict:
    """Main path b: the glm4-9b train step at full width, depth cut to 4
    layers, seq 2048, batch 2, AMP O1 (``cfg`` is the full config; the
    keywords exist to rehearse the path on the host at the smoke size).
    Launch counts are set to 0 just before and read just after; returns
    them."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.kernels.fused.ops import embed_grad_eligible
    from repro_torch.models import api as M
    from repro_torch.models.params import leaves
    from repro_torch.models.transformer import matmul_flops
    from repro_torch.session.session import Session
    from repro_torch.train.step import init_state, make_train_step

    cuda = torch.device(device).type == "cuda"
    cfg4 = dataclasses.replace(cfg, n_layers=layers)
    # the least the opt phase can move: g, m, v, p read and p, m, v written
    # once, all fp32 under O1
    opt_floor_ms = 1e3 * 7 * 4 * cfg4.param_count() / sheet.hbm.bytes_per_s
    want = {"fwd": matmul_flops(cfg4, batch, seq),
            "bwd": 3 * matmul_flops(cfg4, batch, seq), "opt": 0}
    print(f"== 4b. main path: glm4-9b train step, full width, {layers} of "
          f"{cfg.n_layers} layers ({cfg4.param_count() / 1e9:.3f} B params; "
          f"params, grads and both AdamW moments in fp32 take "
          f"{16 * cfg4.param_count() / 1e9:.1f} GB), seq {seq} batch {batch} "
          "amp O1")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device)
    numels = [math.prod(p.shape) for _, p in leaves(M.build(cfg4).spec)]
    for fusion in ("off", "static"):
        t0 = time.perf_counter()
        before = kernels.launch_counts()["fused_adamw"]
        prof = s.profile("glm4-9b", smoke=smoke, n_layers=layers, seq=seq,
                         batch=batch, amp="O1", fusion=fusion, measure=True,
                         iters=5, warmup=2)
        for ph in ("fwd", "bwd", "opt"):
            mm, _ = phase_summary(fusion, ph, prof, sheet)
            # the one-hot embedding gradient is one more matmul where it is
            # eligible (not at full width: 4096·151,552·4 B > 2^28)
            extra = (2 * batch * seq * cfg4.vocab_padded * cfg4.d_model
                     if ph == "bwd" and fusion == "static"
                     and embed_grad_eligible(
                         torch.empty(batch, seq, device="meta"),
                         cfg4.vocab_padded) else 0)
            if mm != want[ph] + extra:
                raise AssertionError(f"{fusion} {ph}: matmul FLOPs {mm} != "
                                     f"{want[ph] + extra}")
        print(f"  {fusion:<6} opt: wall {prof.data['opt'].wall_s * 1e3:.3f} ms"
              f" vs the one-pass floor {opt_floor_ms:.3f} ms (7 x 4 B x "
              f"{cfg4.param_count()} params at the datasheet HBM rate)")
        loss = float(prof.data["fwd"].output)
        print(f"  {fusion:<6} fwd loss {loss:.6f}; profile call "
              f"{time.perf_counter() - t0:.1f} s")
        if not math.isfinite(loss):
            raise AssertionError(f"{fusion} fwd loss is not finite")
        if fusion == "static":
            check_adamw_walk(
                "static opt", prof.analyses["opt"], numels,
                kernels.launch_counts()["fused_adamw"] - before, 5 + 2, cuda)
            print(prof.render(charts=0, top_kernels=8))
        # the opt phase's result holds the params and both moments
        del prof
        if cuda:
            torch.cuda.empty_cache()

    run = RunConfig(amp="O1", fusion="static")
    model = M.build(cfg4)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    step = make_train_step(model, run)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        batch_t = M.synthetic_batch(cfg4, ShapeSpec("t", seq, batch, "train"),
                                    batch, gen, device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_t)
        sync()
        loss = float(metrics["loss"])
        print(f"  static train step {i + 1}: loss {loss:.6f} | grad norm "
              f"{float(metrics['grad_norm']):.4f} | "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
        if not math.isfinite(loss):
            raise AssertionError(f"train step {i + 1}: loss {loss}")
    if cuda:
        print(f"  train steps: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    counts = kernels.launch_counts()
    print(f"launches on main path b: {json.dumps(counts)}")
    for name in FUSED_KERNELS:
        if cuda and counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on main "
                                 "path b")
    del state, step
    return counts


def attention_path(cfg, sheet, *, device: str = "cuda", layers: int = 4,
                   seq: int = 2048, batch: int = 2, smoke: bool = False,
                   workspace: str | None = None) -> dict:
    """Main path c: the path-b train step at ``attn_impl="flash"`` under
    ``fusion="static"`` — its phases profiled, 3 steps, one fwd at
    ``"chunked"`` (which must route to the kernel), and a record written
    and read back.  Launch counts are set to 0 just before and read just
    after; returns them."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import api as M
    from repro_torch.models.transformer import matmul_flops
    from repro_torch.session.session import Session
    from repro_torch.train.step import init_state, make_train_step

    cuda = torch.device(device).type == "cuda"
    cfg4 = dataclasses.replace(cfg, n_layers=layers)
    H, hd = cfg4.n_heads, cfg4.head_dim
    qk_pv = 4 * batch * H * seq * seq * hd * layers
    want_mm = matmul_flops(cfg4, batch, seq) - qk_pv
    want_flash = layers * fk.flops(batch * H, seq, seq, hd)
    iters, warmup = 5, 2
    print(f"== 4c. main path: glm4-9b train step at attn_impl=flash, "
          f"fusion static, full width, {layers} layers, seq {seq} batch "
          f"{batch} amp O1 (fwd matmul FLOPs must be {want_mm}, the flash "
          f"records' {want_flash:.0f})")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device, workspace=workspace)
    t0 = time.perf_counter()
    prof = s.profile("glm4-9b", smoke=smoke, n_layers=layers, seq=seq,
                     batch=batch, amp="O1", fusion="static",
                     attn_impl="flash", measure=True, iters=iters,
                     warmup=warmup)
    for ph in ("fwd", "bwd", "opt"):
        mm, fl = phase_summary("flash", ph, prof, sheet)
        if ph == "fwd" and (mm != want_mm or fl != want_flash):
            raise AssertionError(f"flash fwd: matmul FLOPs {mm} != {want_mm}"
                                 f" or flash FLOPs {fl} != {want_flash}")
    loss = float(prof.data["fwd"].output)
    print(f"  flash  fwd loss {loss:.6f}; profile call "
          f"{time.perf_counter() - t0:.1f} s")
    if not math.isfinite(loss):
        raise AssertionError("flash fwd loss is not finite")
    print(prof.render(charts=0, top_kernels=8))
    # one launch per layer in each fwd pass: the fwd and bwd phases each
    # ran warmup + iters forward passes (the backward launches nothing)
    per_profile = 2 * (warmup + iters) * layers
    got = kernels.launch_counts()["flash_attention"]
    print(f"  flash launches in the profile: {got} (expected {per_profile}"
          f" = 2 phases x {warmup + iters} calls x {layers} layers)")
    if cuda and got != per_profile:
        raise AssertionError(f"flash launches {got} != {per_profile}")
    del prof
    if cuda:
        torch.cuda.empty_cache()

    run = RunConfig(amp="O1", fusion="static", attn_impl="flash")
    model = M.build(cfg4)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    step = make_train_step(model, run)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for i in range(3):
        batch_t = M.synthetic_batch(cfg4, ShapeSpec("t", seq, batch, "train"),
                                    batch, gen, device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_t)
        sync()
        loss = float(metrics["loss"])
        print(f"  flash train step {i + 1}: loss {loss:.6f} | grad norm "
              f"{float(metrics['grad_norm']):.4f} | "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
        if not math.isfinite(loss):
            raise AssertionError(f"flash train step {i + 1}: loss {loss}")
    del state, step
    if cuda:
        torch.cuda.empty_cache()

    before = kernels.launch_counts()["flash_attention"]
    prof = s.profile("glm4-9b", smoke=smoke, n_layers=layers, seq=seq,
                     batch=batch, amp="O1", fusion="static",
                     attn_impl="chunked", phases=("fwd",), measure=True,
                     iters=1, warmup=1)
    routed = kernels.launch_counts()["flash_attention"] - before
    pr = prof.data["fwd"]
    print(f"  chunked (chunk 1024) + static fwd: wall {pr.wall_s * 1e3:.3f} "
          f"ms, loss {float(pr.output):.6f}, flash launches {routed}")
    if cuda and routed != 2 * layers:
        raise AssertionError(f"chunked + static launched flash {routed} "
                             f"times, not {2 * layers}")
    del prof, pr
    if cuda:
        torch.cuda.empty_cache()

    rec = s.record("glm4-9b", smoke=smoke, n_layers=layers, seq=seq,
                   batch=batch, amp="O1", fusion="static", attn_impl="flash",
                   iters=3, warmup=1)
    print(rec.render())
    rep = Session(machine=sheet, device=device,
                  workspace=s.workspace).report("glm4-9b")
    print(f"  report of {rep.provenance['store']}: run "
          f"{rep.data.run_id} (record wrote {rec.data.run_id})")
    if rep.data.run_id != rec.data.run_id or \
            list(rep.phases) != ["fwd", "bwd", "opt"]:
        raise AssertionError("report did not read back the recorded run")
    counts = kernels.launch_counts()
    print(f"launches on main path c: {json.dumps(counts)}")
    if cuda and counts["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched on main "
                             "path c")
    if cuda:
        torch.cuda.empty_cache()
    return counts


#: relative tolerance between the xla and kernel routes' fwd losses under
#: O1: the xla route runs the scan in bf16, the kernel route in fp32 and
#: rounds its output once (the reference's own routes differ the same way).
#: Set from the readings on the H100: 2.889e-6 at full width and depth, so
#: the bound leaves a margin of about 35x and no more
SSD_ROUTE_LOSS_RTOL = 1e-4


def ssm_path(cfg, sheet, *, device: str = "cuda", layers: int | None = None,
             bwd_layers: int = 12, seq: int = 2048, batch: int = 2,
             smoke: bool = False, arch: str = "mamba2-1.3b") -> dict:
    """Main path d: mamba2-1.3b at full width, AMP O1, ``fusion="static"``
    (``cfg`` is the registry config ``arch``; the keywords exist to rehearse
    the path on the host at the smoke size):

    1. the fwd phase at full depth on both SSD routes (``xla``, then
       ``kernel``): finite losses within :data:`SSD_ROUTE_LOSS_RTOL`; at
       ``kernel`` the matmul FLOPs equal ``ssm.matmul_flops``, the
       ssd_scan records' FLOPs equal layers x ``kernel.flops``, and the
       kernel launches once per layer per fwd pass;
    2. the train step at ``kernel``: fwd, bwd and opt phases, then 3
       steps of ``make_train_step``, each with a finite loss;
    3. the bwd phase of both routes at ``bwd_layers`` layers (the xla
       route's autograd keeps (B, chunks, Q, Q, H) tensors a layer).

    Launch counts are set to 0 just before and read just after; returns
    them."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import api as M
    from repro_torch.models.ssm import matmul_flops
    from repro_torch.session.session import Session
    from repro_torch.train.step import init_state, make_train_step

    cuda = torch.device(device).type == "cuda"
    layers = cfg.n_layers if layers is None else layers
    cfg_d = dataclasses.replace(cfg, n_layers=layers)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, seq)
    want_ssd = layers * sk.flops(batch, H, seq, P, N, q)
    iters, warmup = 5, 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def empty_cache():
        if cuda:
            torch.cuda.empty_cache()

    print(f"== 4d. main path: {cfg.name} at full width (d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, {H} heads x {P}, state {N}, "
          f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}), seq {seq} batch "
          f"{batch} amp O1 fusion static; {layers} layers "
          f"({cfg_d.param_count() / 1e9:.3f} B params analytic; params, "
          f"grads and both AdamW moments in fp32 take "
          f"{16 * cfg_d.param_count() / 1e9:.1f} GB)")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device)
    losses = {}
    for impl in ("xla", "kernel"):
        before = kernels.launch_counts()["ssd_scan"]
        t0 = time.perf_counter()
        prof = s.profile(arch, smoke=smoke, n_layers=layers, seq=seq,
                         batch=batch, amp="O1", fusion="static",
                         ssd_impl=impl, phases=("fwd",), measure=True,
                         iters=iters, warmup=warmup)
        mm, fl = phase_summary(impl, "fwd", prof, sheet, custom="ssd_scan")
        losses[impl] = float(prof.data["fwd"].output)
        launched = kernels.launch_counts()["ssd_scan"] - before
        print(f"  {impl:<6} fwd loss {losses[impl]:.6f}; ssd_scan launches "
              f"{launched}; profile call {time.perf_counter() - t0:.1f} s")
        if not math.isfinite(losses[impl]):
            raise AssertionError(f"{impl} fwd loss is not finite")
        if impl == "kernel":
            want_mm = matmul_flops(cfg_d, batch, seq)
            if mm != want_mm or fl != want_ssd:
                raise AssertionError(f"kernel fwd: matmul FLOPs {mm} != "
                                     f"{want_mm} or ssd_scan FLOPs {fl} != "
                                     f"{want_ssd}")
            # one launch per layer in each of the warmup + iters passes
            if cuda and launched != (warmup + iters) * layers:
                raise AssertionError(f"ssd_scan launched {launched} times, "
                                     f"not {(warmup + iters) * layers}")
        del prof
        empty_cache()
    rel = abs(losses["kernel"] - losses["xla"]) / abs(losses["xla"])
    print(f"  fwd loss xla {losses['xla']:.6f} kernel {losses['kernel']:.6f}"
          f": relative difference {rel:.3e} (rtol {SSD_ROUTE_LOSS_RTOL:g})")
    if not rel <= SSD_ROUTE_LOSS_RTOL:
        raise AssertionError(f"the two SSD routes' losses differ by {rel}")

    t0 = time.perf_counter()
    prof = s.profile(arch, smoke=smoke, n_layers=layers, seq=seq,
                     batch=batch, amp="O1", fusion="static", ssd_impl="kernel",
                     measure=True, iters=iters, warmup=warmup)
    for ph in ("fwd", "bwd", "opt"):
        phase_summary("kernel", ph, prof, sheet, custom="ssd_scan")
    print(f"  kernel train phases: profile call "
          f"{time.perf_counter() - t0:.1f} s")
    print(prof.render(charts=0, top_kernels=8))
    del prof
    empty_cache()

    run = RunConfig(amp="O1", fusion="static", ssd_impl="kernel")
    model = M.build(cfg_d)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    step = make_train_step(model, run)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        batch_t = M.synthetic_batch(cfg_d, ShapeSpec("t", seq, batch,
                                                     "train"),
                                    batch, gen, device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_t)
        sync()
        loss = float(metrics["loss"])
        print(f"  kernel train step {i + 1}: loss {loss:.6f} | grad norm "
              f"{float(metrics['grad_norm']):.4f} | "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
        if not math.isfinite(loss):
            raise AssertionError(f"kernel train step {i + 1}: loss {loss}")
    if cuda:
        print(f"  train steps: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, step
    empty_cache()

    for impl in ("xla", "kernel"):
        prof = s.profile(arch, smoke=smoke, n_layers=bwd_layers, seq=seq,
                         batch=batch, amp="O1", fusion="static",
                         ssd_impl=impl, phases=("bwd",), measure=True,
                         iters=iters, warmup=warmup)
        phase_summary(f"{impl}@{bwd_layers}", "bwd", prof, sheet,
                      custom="ssd_scan")
        del prof
        empty_cache()

    counts = kernels.launch_counts()
    print(f"launches on main path d: {json.dumps(counts)}")
    for name in ("ssd_scan", "fused_rmsnorm", "fused_adamw"):
        if cuda and counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on main "
                                 "path d")
    return counts


#: relative tolerance between the fwd losses of the ``auto`` and ``static``
#: routes of path e: a site that chose ``reference`` computes the same
#: function as the kernel but rounds elsewhere (the plain SwiGLU rounds
#: silu(g) to bf16 before the product; the kernel rounds once).  Set from
#: the readings, a few times the larger: 1.088e-5 on the H100 at 4 layers,
#: 5.1e-5 at the smoke size on the host.  At random initialisation the
#: loss sits near ln(vocab) and moves little per element, so the bound is
#: kept near the readings for a wrong route to show
ROUTE_LOSS_RTOL = 2e-4


@contextlib.contextmanager
def launch_sources(session):
    """Yield a dict that fills, for every launch in the body of a kernel
    that reads its config from the tune store (``for_launch`` with no
    config), with (kernel, shape, dtype) → ``"tuned"`` or ``"default"``,
    as the session's store answers it."""
    from repro_torch.kernels import config as kc
    from repro_torch.tune import dispatch as dsp
    from repro_torch.tune.space import STEP_KERNELS
    from repro_torch.tune.store import config_source
    plain, sources = kc.for_launch, {}

    def for_launch(kernel, config, t, shape):
        if config is None and kernel in STEP_KERNELS:
            point = (kernel, tuple(int(d) for d in shape),
                     dsp.dtype_name(t.dtype))
            sources[point] = config_source(
                *point, machine=session.machine.name,
                store=session.workspace.tune_store)[0]
        return plain(kernel, config, t, shape)

    kc.for_launch = for_launch
    try:
        yield sources
    finally:
        kc.for_launch = plain


def tuning_path(cfg, sheet, untuned, *, device: str = "cuda",
                layers: int = 4, seq: int = 2048, batch: int = 2,
                smoke: bool = False, workspace: str | None = None) -> dict:
    """Main path e: tuning and the measured dispatch (``cfg`` is the full
    glm4-9b; ``untuned`` the machine path a measured; the keywords exist
    to rehearse the path on the host at the smoke size):

    1. ``Session.tune()`` of the step (the fused kernels at every
       (shape, dtype) the ``layers``-layer step launches them at, the
       ERT kernels through the ceiling searches), then again: every
       point a store hit, nothing timed;
    2. ``Session.characterize(empirical=True, tuned=True)``: each tuned
       ceiling ≥ 0.97x the untuned one of path a and ≤ 1.05x the
       datasheet (the on-chip level above the measured HBM roof);
    3. the dispatch search of the ``layers``-layer train step at
       ``attn_impl="chunked"``, plus the layernorm site (4096, 4096) bf16
       through ``measure_site`` — the route the reference reaches
       ``fused_layernorm`` by — then again: nothing measured;
    4. the train step's phases at ``fusion="auto"`` under
       ``REPRO_DISPATCH=frozen`` (every site must hit) beside
       ``"static"``: fwd losses within :data:`ROUTE_LOSS_RTOL`; under
       ``auto`` the AdamW leaves take the kernel as one dtype group,
       one launch an opt call (``ops.adamw_routes``);
    5. ``Session.record`` at ``auto``, read back with its
       ``kernel_configs`` and ``dispatch_table``; every launch of a
       fused kernel in it finds a tuned config in the store.

    Launch counts are set to 0 just before and read just after; returns
    them."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.models import api as M
    from repro_torch.models.params import leaves
    from repro_torch.session.session import Session
    from repro_torch.tune import dispatch as dsp

    cuda = torch.device(device).type == "cuda"
    numels = [math.prod(p.shape) for _, p in leaves(M.build(
        dataclasses.replace(cfg, n_layers=layers)).spec)]
    print(f"== 4e. main path: tuning and the measured dispatch (workspace "
          f"{workspace})")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device, workspace=workspace)

    # 1. the kernels' launch configs, at the points the step launches them
    t0 = time.perf_counter()
    step = dict(config="glm4-9b", full=not smoke, seq=seq, batch=batch,
                n_layers=layers, attn_impl="chunked")
    tuned = s.tune(smoke=smoke, **step)
    print(f"  tune: {len(tuned.data)} points in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, oc in tuned.data.items():
        r = oc.record
        # a step point's name is its kernel, shape and dtype
        print(f"  tune {name.split()[0]:<16} "
              f"{'x'.join(map(str, r.shape)):<18} "
              f"{r.dtype:<8} default {r.default_wall_s * 1e3:.4f} ms -> "
              f"tuned {r.wall_s * 1e3:.4f} ms ({r.speedup:.3f}x, "
              f"{r.n_candidates} candidates) {r.params}")
        if oc.cached:
            raise AssertionError(f"tune {name}: a store hit in a fresh "
                                 "workspace")
    got = {oc.record.kernel for oc in tuned.data.values()}
    if cuda and not {"fused_norm", "fused_swiglu", "fused_adamw", "triad",
                     "fma_chain", "ert_gemm"} <= got:
        raise AssertionError(f"tune searched only {sorted(got)}")
    again = s.tune(smoke=smoke, **step)
    timed = [n for n, oc in again.data.items() if not oc.cached
             or oc.candidates]
    print(f"  tune again: {len(again.data)} store hits, {len(timed)} timed")
    if timed:
        raise AssertionError(f"second tune pass timed {timed}")

    # 2. tuned ceilings
    t0 = time.perf_counter()
    meas = s.characterize(empirical=True, tuned=True, smoke=smoke).machine
    print(f"  characterize(tuned=True): {time.perf_counter() - t0:.1f} s")
    for name, got, base, peak in (
            ("f32", meas.peak_flops["f32"], untuned.peak_flops["f32"],
             sheet.peak_flops["f32"]),
            ("bf16", meas.peak_flops["bf16"], untuned.peak_flops["bf16"],
             sheet.peak_flops["bf16"]),
            ("hbm", meas.hbm.bytes_per_s, untuned.hbm.bytes_per_s,
             sheet.hbm.bytes_per_s),
            (meas.vmem.name, meas.vmem.bytes_per_s, untuned.vmem.bytes_per_s,
             None)):
        print(f"  ceiling {name:<5} tuned {got:.4e} untuned {base:.4e} "
              f"({got / base:.4f}x)"
              + (f" datasheet {peak:.4e} ({100 * got / peak:.1f}%)"
                 if peak else f" (must exceed the tuned hbm "
                              f"{meas.hbm.bytes_per_s:.4e})"))
        if cuda and not got >= 0.97 * base:
            raise AssertionError(f"tuned ceiling {name} {got} below 0.97 x "
                                 f"the untuned {base}")
        if cuda and peak and not got <= 1.05 * peak:
            raise AssertionError(f"tuned ceiling {name} {got} above 1.05 x "
                                 f"the datasheet {peak}")
    if cuda and not meas.vmem.bytes_per_s > meas.hbm.bytes_per_s:
        raise AssertionError("tuned on-chip ceiling not above the HBM one")

    # 3. the dispatch table
    t0 = time.perf_counter()
    before = kernels.launch_counts()
    search = dict(dispatch=True, **step)
    found = s.tune(**search).data
    print(f"  {found.describe()}")
    print(f"  dispatch search: {time.perf_counter() - t0:.1f} s")
    after = kernels.launch_counts()
    ops = {r.op for r in found.records}
    for op, kernel in (("fused_norm", "fused_rmsnorm"),
                       ("fused_norm", "fused_rmsnorm_residual"),
                       ("fused_swiglu", "fused_swiglu"),
                       ("fused_adamw", "fused_adamw"),
                       ("flash_attn", "flash_attention")):
        if cuda and op in ops and after[kernel] <= before[kernel]:
            raise AssertionError(f"the fused candidate of {op} did not "
                                 f"launch {kernel}")
    x = torch.empty((4096, 4096), dtype=torch.bfloat16, device="meta")
    sc = torch.empty(4096, device="meta")
    with dsp.dispatch_scope(store=s.workspace.tune_store,
                            machine=s.machine.name, device=s.device):
        key = dsp.norm_key(x, sc, sc, kind="layernorm")
        rec = dsp.measure_site(key)
    print(f"  layernorm site {key.key}\n    {rec.describe()}")
    again = s.tune(**search).data
    with dsp.dispatch_scope(store=s.workspace.tune_store,
                            machine=s.machine.name, device=s.device,
                            mode="measure") as scope:
        dsp.decide(key)
    print(f"  dispatch search again: {again.n_sites} sites, "
          f"{again.n_measured} measured; layernorm site "
          f"{scope.n_measured} measured")
    if again.n_measured or scope.n_measured:
        raise AssertionError("the second dispatch search measured a site")
    if cuda and kernels.launch_counts()["fused_layernorm"] <= 0:
        raise AssertionError("fused_layernorm was not launched by its "
                             "dispatch site")

    # 4 and 5: every launch of a kernel that reads its config from the
    # store finds the tuned winner of its point
    with launch_sources(s) as sources:
        # 4. the step from the table, beside static
        losses, walls = {}, {}
        with dsp.dispatch_scope(mode="frozen") as scope:
            for fusion in ("static", "auto"):
                scope.reset_stats()
                before = kernels.launch_counts()["fused_adamw"]
                prof = s.profile(
                    "glm4-9b", smoke=smoke, n_layers=layers, seq=seq,
                    batch=batch, amp="O1", fusion=fusion,
                    attn_impl="chunked", measure=True, iters=5, warmup=2)
                if fusion == "auto" and cuda:
                    # (on the host the plain versions' timings decide the
                    # table, and may route the group to the chain)
                    check_adamw_walk(
                        "auto opt", prof.analyses["opt"], numels,
                        kernels.launch_counts()["fused_adamw"] - before,
                        5 + 2, cuda)
                losses[fusion] = float(prof.data["fwd"].output)
                walls[fusion] = {ph: prof.data[ph].wall_s * 1e3
                                 for ph in ("fwd", "bwd", "opt")}
                if fusion == "auto":
                    table = {r.key: r.impl for r in dsp.dispatch_table(
                        s.workspace.tune_store, s.machine.name)}
                    print(f"  auto: {len(scope.sites)} sites, {scope.n_hit} "
                          f"lookups, {scope.n_measured} measured")
                    for k in sorted(scope.sites):
                        print(f"    {table[k]:<9} {k}")
                del prof
                if cuda:
                    torch.cuda.empty_cache()
        for ph in ("fwd", "bwd", "opt"):
            print(f"  {ph}: auto {walls['auto'][ph]:.3f} ms | static "
                  f"{walls['static'][ph]:.3f} ms")
        rel = abs(losses["auto"] - losses["static"]) / abs(losses["static"])
        print(f"  fwd loss auto {losses['auto']:.6f} static "
              f"{losses['static']:.6f} (rel {rel:.3e}, bound "
              f"{ROUTE_LOSS_RTOL:g})")
        if not (math.isfinite(losses["auto"]) and rel <= ROUTE_LOSS_RTOL):
            raise AssertionError(f"auto fwd loss {losses['auto']} vs static "
                                 f"{losses['static']}")

        # 5. a record under auto carries the table
        with dsp.dispatch_scope(mode="frozen"):
            rec = s.record("glm4-9b", smoke=smoke, n_layers=layers, seq=seq,
                           batch=batch, amp="O1", fusion="auto",
                           attn_impl="chunked", iters=2, warmup=1)
    print("  launch configs in steps 4 and 5: "
          + ", ".join(f"{k} {'x'.join(map(str, sh))} {dt}: {src}"
                      for (k, sh, dt), src in sorted(sources.items())))
    if cuda and (not sources or set(sources.values()) != {"tuned"}):
        raise AssertionError(f"a launch found no tuned config: {sources}")
    meta = s.report("glm4-9b").data.meta
    stamped = {k: v["source"] for k, v in meta["kernel_configs"].items()}
    print(f"  record {rec.data.run_id}: kernel_configs {stamped}; "
          f"dispatch_table {len(meta['dispatch_table'])} sites")
    if s.report("glm4-9b").data.run_id != rec.data.run_id or \
            not meta["dispatch_table"] or meta["fusion"] != "auto":
        raise AssertionError("the auto record did not read back with its "
                             "dispatch table")
    counts = kernels.launch_counts()
    print(f"launches on main path e: {json.dumps(counts)}")
    if cuda:
        torch.cuda.empty_cache()
    return counts


#: relative tolerance between the fwd losses of DeepCAM's two lowerings
#: under O1: ``reference`` runs every norm in fp32, ``fused`` folds it into
#: the conv and stays in bf16, so they round at other places.  At random
#: initialisation the logits are small and the loss sits near ln 3, so the
#: bound is kept tight.  Set from the reading on the host at the smoke size
#: (width 8, (64, 96), batch 2): 0, both losses 1.0986089
DEEPCAM_LOSS_RTOL = 1e-4


def deepcam_path(cfg, sheet, measured, *, device: str = "cuda",
                 batch: int = 2, smoke: bool = False,
                 workspace: str | None = None) -> dict:
    """Main path f: DeepCAM (``cfg``, the registry's ``deepcam``: the
    paper's network) at full width at the paper's resolution, batch
    ``batch``, AMP O1, ``fusion="static"``, in both lowerings (``smoke``
    with the smoke config rehearses it on the host at width 8 and
    (64, 96)):

    1. each lowering's fwd, bwd and opt phases profiled with
       ``measure=True``: wall, bound and %-of-roofline against the
       datasheet and the ``measured`` ceilings, peak memory, launches,
       zero-AI launches and bytes, conv FLOPs and HBM bytes.  The fwd conv
       FLOPs must equal the analytic count, the bwd's 3x it less the
       stem's input gradient, the opt's 0; ``fused_adamw`` must launch
       once in each opt call (one dtype group), and the opt walk hold one
       ``adamw_multi_`` record whose bytes and FLOPs are the sums of the
       370 one-leaf models (:func:`check_adamw_walk`);
    2. the reference benchmark's facts: bwd FLOPs above fwd FLOPs, the
       opt phase memory-bound; ``reference``'s fwd holds more zero-AI
       launches and more HBM bytes than ``fused``'s (paper Table III);
       the two fwd losses finite and within :data:`DEEPCAM_LOSS_RTOL`;
    3. 3 steps of ``make_train_step`` at ``reference``, each with a finite
       loss, then ``Session.record`` and ``Session.report``, which must
       read the same run back.

    Launch counts are set to 0 just before and read just after; returns
    them."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.deepcam import IMAGE_HW, SMOKE_HW
    from repro_torch.core.roofline import roofline_terms
    from repro_torch.models import api as M
    from repro_torch.models import deepcam as DC
    from repro_torch.models.params import count, leaves
    from repro_torch.session.session import Session
    from repro_torch.train.step import init_state, make_train_step

    cuda = torch.device(device).type == "cuda"
    hw = SMOKE_HW if smoke else IMAGE_HW
    width = cfg.d_model
    spec = DC.deepcam_spec(width)
    numels = [math.prod(p.shape) for _, p in leaves(spec)]
    n_leaves = len(numels)
    want_fwd = DC.conv_flops(width, hw, batch)
    _, h, w, k, cin, cout, _ = DC.conv_plan(width, hw)[0]
    stem_dgrad = 2 * batch * h * w * k * k * cin * cout
    want = {"fwd": want_fwd, "bwd": 3 * want_fwd - stem_dgrad, "opt": 0}
    iters, warmup = 5, 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def empty_cache():
        if cuda:
            torch.cuda.empty_cache()

    print(f"== 4f. main path: {cfg.name}, stem width {width} "
          f"({count(spec)} params in {n_leaves} leaves), images "
          f"({batch}, {hw[0]}, {hw[1]}, {DC.IN_CHANNELS}), amp O1, fusion "
          f"static, both lowerings (fwd conv FLOPs must be {want_fwd} over "
          f"{len(DC.conv_plan(width, hw))} convs, bwd {want['bwd']})")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device, workspace=workspace)
    census, losses = {}, {}
    for impl in ("reference", "fused"):
        before = kernels.launch_counts()["fused_adamw"]
        t0 = time.perf_counter()
        prof = s.profile("deepcam", smoke=smoke, batch=batch, amp="O1",
                         fusion="static", impl=impl, measure=True,
                         iters=iters, warmup=warmup)
        for ph in ("fwd", "bwd", "opt"):
            conv, _ = phase_summary(impl[:6], ph, prof, sheet,
                                    custom="adamw_multi_", dense="conv")
            ana, wall = prof.analyses[ph], prof.data[ph].wall_s
            frac = {name: roofline_terms(ana, m).bound_overlap_s / wall
                    for name, m in (("datasheet", sheet),
                                    ("measured", measured))}
            print(f"  {impl[:6]:<6} {ph}: {100 * frac['datasheet']:.2f}% of "
                  f"the datasheet roofline, {100 * frac['measured']:.2f}% of "
                  f"the measured ({roofline_terms(ana, measured).dominant}"
                  "-bound)")
            if conv != want[ph]:
                raise AssertionError(f"{impl} {ph}: conv FLOPs {conv} != "
                                     f"{want[ph]}")
        fwd, bwd, opt = (prof.analyses[ph] for ph in ("fwd", "bwd", "opt"))
        census[impl] = fwd
        losses[impl] = float(prof.data["fwd"].output)
        conv_share = sum(k.total_flops for k in fwd.kernels
                         if k.category == "conv") / fwd.total_flops
        opt_dom = roofline_terms(opt, sheet).dominant
        print(f"  {impl[:6]:<6} fwd loss {losses[impl]:.7f} | conv FLOP share "
              f"of fwd {conv_share:.4f} | bwd FLOPs {bwd.total_flops:.0f} vs "
              f"fwd {fwd.total_flops:.0f} | opt {opt_dom}-bound | profile "
              f"call {time.perf_counter() - t0:.1f} s")
        if not math.isfinite(losses[impl]):
            raise AssertionError(f"{impl} fwd loss is not finite")
        if not bwd.total_flops > fwd.total_flops or opt_dom != "memory":
            raise AssertionError(f"{impl}: bwd FLOPs not above fwd, or opt "
                                 f"{opt_dom}-bound")
        # one fused AdamW launch (the one f32 group) in each of the warmup
        # + iters opt calls (fwd and bwd launch none); the walk one
        # adamw_multi_ record with the sums of the per-leaf models
        launched = kernels.launch_counts()["fused_adamw"] - before
        check_adamw_walk(f"{impl} opt", opt, numels, launched,
                         warmup + iters, cuda)
        if impl == "reference":
            print(prof.render(charts=0, top_kernels=8))
        del prof, fwd, bwd, opt
        empty_cache()

    z = {impl: a.zero_ai_census() for impl, a in census.items()}
    for impl, c in z.items():
        print(f"  census {impl:<9} fwd: zero-AI {c['zero-AI'][0]} launches, "
              f"{c['zero-AI'][1]} B | non zero-AI {c['non zero-AI'][0]} "
              f"launches, {c['non zero-AI'][1]} B | HBM bytes "
              f"{census[impl].total_hbm_bytes:.0f}")
    if not (z["reference"]["zero-AI"][0] > z["fused"]["zero-AI"][0]
            and census["reference"].total_hbm_bytes >
            census["fused"].total_hbm_bytes):
        raise AssertionError("reference fwd does not hold more zero-AI "
                             "launches and HBM bytes than fused")
    rel = abs(losses["fused"] - losses["reference"]) / abs(
        losses["reference"])
    print(f"  fwd loss reference {losses['reference']:.7f} fused "
          f"{losses['fused']:.7f}: relative difference {rel:.3e} (rtol "
          f"{DEEPCAM_LOSS_RTOL:g})")
    if not rel <= DEEPCAM_LOSS_RTOL:
        raise AssertionError(f"the two lowerings' losses differ by {rel}")
    del census

    run = RunConfig(amp="O1", fusion="static", impl="reference")
    model = M.build(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    step = make_train_step(model, run)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        batch_t = M.synthetic_batch(cfg, ShapeSpec("t", 0, batch, "train"),
                                    batch, gen, device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_t)
        sync()
        loss = float(metrics["loss"])
        print(f"  reference train step {i + 1}: loss {loss:.6f} | grad norm "
              f"{float(metrics['grad_norm']):.6f} | "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
        if not math.isfinite(loss):
            raise AssertionError(f"deepcam train step {i + 1}: loss {loss}")
    if cuda:
        print(f"  train steps: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, step, batch_t
    empty_cache()

    rec = s.record("deepcam", smoke=smoke, batch=batch, amp="O1",
                   fusion="static", impl="reference", iters=3, warmup=1)
    print(rec.render())
    rep = Session(machine=sheet, device=device,
                  workspace=s.workspace).report("deepcam")
    print(f"  report of {rep.provenance['store']}: run "
          f"{rep.data.run_id} (record wrote {rec.data.run_id})")
    if rep.data.run_id != rec.data.run_id or \
            list(rep.phases) != ["fwd", "bwd", "opt"]:
        raise AssertionError("report did not read back the recorded run")
    counts = kernels.launch_counts()
    print(f"launches on main path f: {json.dumps(counts)}")
    if cuda and counts["fused_adamw"] <= 0:
        raise AssertionError("fused_adamw was not launched on main path f")
    empty_cache()
    return counts


def adamw_leaves_row(params, sheet, label: str) -> dict:
    """``fused_adamw`` on one model's f32 leaves, as the opt phase
    launches it (their shapes, one multi-tensor launch per dtype group):
    first one call that is not in place, every leaf's p, m and v held
    against ``adamw_ref`` (1 ulp of f32 at the leaf's max|ref|, as
    :func:`adamw_multi_checks`); then the call in place timed in a
    replayed CUDA graph beside ``torch._fused_adamw_`` on the same leaves,
    and the loop of plain chains timed eagerly (its temporaries, a leaf at
    a time, would stay allocated in a graph): a row at a new shape
    (gradients and moments drawn here, so the row needs three more copies
    of the leaves, and the check three more)."""
    import torch
    from repro_torch.kernels.ert import ops as ert_ops
    from repro_torch.kernels.fused import adamw
    from torch.utils._pytree import tree_flatten

    ps = [p for p in tree_flatten(params)[0]]
    dev = ps[0].device
    gen = torch.Generator(device=dev).manual_seed(5)
    gs = [torch.randn(p.shape, generator=gen, device=dev) for p in ps]
    ms = [torch.randn(p.shape, generator=gen, device=dev) * 0.1 for p in ps]
    vs = [torch.rand(p.shape, generator=gen, device=dev) * 0.01 for p in ps]
    bc = torch.tensor([1 - 0.9 ** 3, 1 - 0.95 ** 3], device=dev)
    hyper = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    before = adamw.LAUNCHES
    got = adamw.fused_adamw_multi(gs, ms, vs, ps, bc, **hyper)
    took = adamw.LAUNCHES - before
    err = worst = 0.0
    for i, leaf in enumerate(zip(gs, ms, vs, ps)):
        for out, want in zip((t[i] for t in got),
                             adamw.adamw_ref(*leaf, bc, **hyper)):
            d = (out - want).abs().max().item()
            ulp = 2.0 ** -22 * want.abs().max().item() + 1e-30
            err, worst = max(err, d), max(worst, d / ulp)
    del got
    ok = worst <= 1.0 and math.isfinite(err) and took == 1
    print(f"  fused_adamw_multi {label}: {len(ps)} f32 leaves in {took} "
          f"launch(es), p, m and v of every leaf against adamw_ref: "
          f"max_abs_err {err:.3e}  max err/tol {worst:.3f} (tolerance 1 ulp "
          f"of f32 at the leaf's max|ref|)  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"fused_adamw_multi on the {label} leaves: "
                             f"{took} launches (one expected), an error "
                             f"reaches {worst} of its bound")
    steps = [torch.tensor(3.0, device=dev) for _ in ps]
    n = sum(p.numel() for p in ps)
    row = {"name": "fused_adamw", "at_shape": True, "max_abs_err": err,
           "shape": f"{len(ps)} f32 leaves, {n} params, in place ({label})",
           "config": launch_config("fused_adamw", ps[0],
                                   adamw.lookup_shape(n)),
           "ms": graph_ms(lambda: adamw.fused_adamw_multi(
               gs, ms, vs, ps, bc, inplace=True, **hyper), calls=2),
           "plain_ms": 1e3 * ert_ops.time_launches(lambda: [
               adamw.adamw_ref(g, m, v, p, bc, **hyper) for g, m, v, p in
               zip(gs, ms, vs, ps)], dev, iters=2, warmup=1),
           "library_ms": graph_ms(lambda: torch._fused_adamw_(
               ps, gs, ms, vs, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
               weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False),
               calls=2),
           **bound(sum(adamw.hbm_bytes(p.numel()) for p in ps),
                   sum(adamw.flops(p.numel()) for p in ps), "f32", sheet)}
    del gs, ms, vs
    torch.cuda.empty_cache()
    return row


def hybrid_path(cfg, sheet, *, device: str = "cuda", layers: int | None = None,
                seq: int = 2048, batch: int = 2, smoke: bool = False,
                arch: str = "zamba2-1.2b") -> tuple[dict, list[dict]]:
    """Main path g: zamba2-1.2b (38 Mamba-2 layers, one shared attention
    and MLP block at 6 sites) at full width and depth, seq 2048, batch 2,
    AMP O1, ``fusion="static"``, ``ssd_impl="kernel"``,
    ``attn_impl="flash"`` (``cfg`` is the registry config ``arch``; the
    keywords exist to rehearse the path on the host at the smoke size):

    1. the fwd, bwd and opt phases profiled with ``measure=True``: fwd
       matmul FLOPs equal ``hybrid.matmul_flops`` less the sites' QKᵀ and
       PV, the ssd_scan records carry layers × the kernel's FLOPs and the
       flash records one a site; each fwd pass launches ssd_scan once a
       layer and flash once a site, each opt call ``fused_adamw`` once;
    2. 3 steps of ``make_train_step``, each with a finite loss, the peak
       memory, then ``fused_adamw`` timed on the model's leaves;
    3. the fwd at ``ssd_impl="xla"``: its loss within
       :data:`SSD_ROUTE_LOSS_RTOL` of the kernel route's.

    Launch counts are set to 0 just before and read just after; returns
    them and the AdamW row."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import api as M
    from repro_torch.models import hybrid as HY
    from repro_torch.models import transformer as TR
    from repro_torch.models.params import leaves
    from repro_torch.session.session import Session
    from repro_torch.train.step import init_state, make_train_step

    cuda = torch.device(device).type == "cuda"
    layers = cfg.n_layers if layers is None else layers
    cfg_g = dataclasses.replace(cfg, n_layers=layers)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, seq)
    n_sites = HY.n_shared_sites(cfg_g)
    qk_pv = TR.attention_flops(cfg_g, batch, seq)["qk_pv"]
    want_mm = HY.matmul_flops(cfg_g, batch, seq) - n_sites * qk_pv
    want_ssd = layers * sk.flops(batch, H, seq, P, N, q)
    want_flash = n_sites * fk.flops(batch * cfg.n_heads, seq, seq,
                                    cfg.head_dim)
    iters, warmup = 5, 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    numels = [math.prod(p.shape) for _, p in leaves(M.build(cfg_g).spec)]
    n_params = sum(numels)
    print(f"== 4g. main path: {cfg.name} hybrid at full width (d_model "
          f"{cfg.d_model}, {H} SSM heads x {P}, state {N}, chunk "
          f"{cfg.ssm_chunk}; shared block {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads x {cfg.head_dim}, d_ff {cfg.d_ff}, act {cfg.act}; vocab "
          f"{cfg.vocab_size}), {layers} layers and {n_sites} sites "
          f"({n_params} params in the spec tree; params, grads and both "
          f"AdamW moments in fp32 take {16 * n_params / 1e9:.1f} GB), seq "
          f"{seq} batch {batch} amp O1 fusion static ssd kernel attn flash "
          f"(fwd matmul FLOPs must be {want_mm}, ssd_scan {want_ssd:.0f}, "
          f"flash {want_flash:.0f})")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device)
    kw = dict(smoke=smoke, n_layers=layers, seq=seq, batch=batch, amp="O1",
              fusion="static", attn_impl="flash")
    t0 = time.perf_counter()
    prof = s.profile(arch, ssd_impl="kernel", measure=True, iters=iters,
                     warmup=warmup, **kw)
    got = kernels.launch_counts()
    for ph in ("fwd", "bwd", "opt"):
        mm, fl = phase_summary("kernel", ph, prof, sheet, custom="ssd_scan")
        if ph == "fwd":
            fa = sum(k.total_flops for k in prof.analyses[ph].kernels
                     if k.opcode == "flash_attention")
            if mm != want_mm or fl != want_ssd or fa != want_flash:
                raise AssertionError(
                    f"hybrid fwd: matmul FLOPs {mm} != {want_mm}, ssd_scan "
                    f"{fl} != {want_ssd} or flash {fa} != {want_flash}")
    passes = 2 * (warmup + iters)       # the fwd and bwd phases' fwd passes
    want_launch = {"ssd_scan": passes * layers,
                   "flash_attention": passes * n_sites}
    print(f"  launches in the profile: ssd_scan {got['ssd_scan']}, flash "
          f"{got['flash_attention']}, fused_adamw {got['fused_adamw']} "
          f"(expected {want_launch} over {passes} fwd passes, and one "
          f"fused_adamw a opt call); profile call "
          f"{time.perf_counter() - t0:.1f} s")
    if cuda and any(got[k] != v for k, v in want_launch.items()):
        raise AssertionError(f"hybrid launches {got} != {want_launch}")
    check_adamw_walk("hybrid opt", prof.analyses["opt"], numels,
                     got["fused_adamw"], warmup + iters, cuda)
    losses = {"kernel": float(prof.data["fwd"].output)}
    print(prof.render(charts=0, top_kernels=8))
    del prof
    if cuda:
        torch.cuda.empty_cache()

    run = RunConfig(amp="O1", fusion="static", ssd_impl="kernel",
                    attn_impl="flash")
    model = M.build(cfg_g)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    step = make_train_step(model, run)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        batch_t = M.synthetic_batch(cfg_g, ShapeSpec("t", seq, batch,
                                                     "train"), batch, gen,
                                    device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_t)
        sync()
        loss = float(metrics["loss"])
        print(f"  hybrid train step {i + 1}: loss {loss:.6f} | grad norm "
              f"{float(metrics['grad_norm']):.4f} | "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
        if not math.isfinite(loss):
            raise AssertionError(f"hybrid train step {i + 1}: loss {loss}")
    if cuda:
        print(f"  train steps: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del step, batch_t
    counts = kernels.launch_counts()
    row = (adamw_leaves_row(state.params, sheet, f"{cfg.name}, path g")
           if cuda else None)
    del state
    if cuda:
        torch.cuda.empty_cache()

    prof = s.profile(arch, ssd_impl="xla", phases=("fwd",), measure=True,
                     iters=1, warmup=1, **kw)
    losses["xla"] = float(prof.data["fwd"].output)
    phase_summary("xla", "fwd", prof, sheet, custom="ssd_scan")
    del prof
    if cuda:
        torch.cuda.empty_cache()
    rel = abs(losses["kernel"] - losses["xla"]) / abs(losses["xla"])
    print(f"  fwd loss xla {losses['xla']:.6f} kernel {losses['kernel']:.6f}"
          f": relative difference {rel:.3e} (rtol {SSD_ROUTE_LOSS_RTOL:g})")
    if not (math.isfinite(rel) and rel <= SSD_ROUTE_LOSS_RTOL):
        raise AssertionError(f"the hybrid's SSD routes' losses differ by "
                             f"{rel}")
    print(f"launches on main path g: {json.dumps(counts)}")
    for name in ("ssd_scan", "flash_attention", "fused_rmsnorm",
                 "fused_rmsnorm_residual", "fused_adamw"):
        if cuda and counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on main "
                                 "path g")
    return counts, [row] if row else []


#: the parameters of mistral-large-123b (the reference's ``param_count``;
#: this script imports nothing of the reference)
MISTRAL_PARAMS = 122_610_069_504

#: how far path h's gradients under remat "dots" and "full" may lie from
#: remat "none"'s, relative to each leaf's largest |gradient|: the
#: recompute runs the same kernels on the same inputs, so the readings
#: are expected to be 0; a bound above it would take a kernel choice that
#: depends on free memory (cuBLAS's workspace)
REMAT_GRAD_TOL = 1e-3


def remat_held_check(model, params, batch_t, cfg, tokens: int) -> None:
    """What each remat mode keeps for the backward, read on the card: the
    device bytes that one fwd with gradients leaves allocated (after the
    bwd runs above, so the cuBLAS workspace is there already).  ``dots``
    must keep exactly the products against a weight (q, k, v, o and the
    MLP's, in the compute dtype, a layer each) above ``full``, and the
    modes must read ``none > dots > full``."""
    import torch
    from repro_torch.configs.base import RunConfig
    from torch.utils._pytree import tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    mlp = (2 if cfg.act in ("swiglu", "geglu") else 1) * cfg.d_ff \
        + cfg.d_model
    attn = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + cfg.d_model
    want = cfg.n_layers * tokens * (attn + mlp) * 2       # bf16 at O1
    held = {}
    for mode in ("none", "dots", "full"):
        run = RunConfig(amp="O1", fusion="static", remat=mode)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loss = model.loss_fn(leaves, batch_t, run)[0]
        torch.cuda.synchronize()
        held[mode] = torch.cuda.memory_allocated() - base
        del loss
    print(f"  bytes one fwd keeps for the bwd: none {held['none']}, dots "
          f"{held['dots']}, full {held['full']}; dots - full "
          f"{held['dots'] - held['full']} (the products against a weight: "
          f"{want} B, {cfg.n_layers} layers x {tokens} tokens x "
          f"{attn + mlp} columns x 2 B)")
    if not (held["none"] > held["dots"] > held["full"]
            and held["dots"] - held["full"] == want):
        raise AssertionError(f"remat keeps {held}; dots - full is not the "
                             f"{want} B of the products against a weight")


def dense_family_path(granite, minitron, mistral, sheet, *,
                      device: str = "cuda", layers: int = 4,
                      minitron_layers: int | None = None, seq: int = 2048,
                      batch: int = 2, smoke: bool = False) -> dict:
    """Main path h: the rest of the dense family and its memory features,
    AMP O1, ``fusion="static"`` (the configs are the registry's; the
    keywords exist to rehearse the path on the host at the smoke size):

    1. granite-8b at full width, depth cut to ``layers``, einsum
       attention: the fwd and bwd phases under remat ``none``, ``dots``
       and ``full`` — the fwd losses equal, the bwd's peak memory strictly
       ``none > dots > full``, the bwd walk's matmul FLOPs 3x the fwd's
       plus each mode's recompute (``dots``: the batched QKᵀ and PV;
       ``full``: each block's products but its last), the gradients of
       ``dots`` and ``full`` within :data:`REMAT_GRAD_TOL` of ``none``'s,
       ``model_flops_ratio`` printed for each, on the card
       :func:`remat_held_check`; then one fwd at ``attn_impl="flash"``
       (one launch a layer, G = 4);
    2. minitron-4b at full width and depth (``minitron_layers`` cuts it),
       ``optimizer="adafactor"``, ``remat="full"``: the fwd, bwd and opt
       phases profiled (matmul FLOPs with two MLP products and the
       256,000-column unembedding; the bwd's recompute), 3 steps with a
       finite loss, the peak memory and Adafactor's state beside AdamW's;
    3. mistral-large-123b's fwd walk at full width and depth on meta
       tensors (nothing allocated): matmul FLOPs equal
       ``transformer.matmul_flops`` and ``param_count``
       :data:`MISTRAL_PARAMS`.

    Launch counts are set to 0 just before and read just after; returns
    them."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.core.roofline import model_flops_ratio
    from repro_torch.kernels.fused.ops import embed_grad_eligible
    from repro_torch.models import api as M
    from repro_torch.models import transformer as TR
    from repro_torch.models.params import init
    from repro_torch.session.session import Session
    from repro_torch.train.step import init_state, make_phases, \
        make_train_step
    from torch.utils._pytree import tree_flatten

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def empty_cache():
        if cuda:
            torch.cuda.empty_cache()

    def recompute(cfg, mode):
        """The matmul FLOPs the bwd phase adds under remat ``mode``."""
        att = TR.attention_flops(cfg, batch, seq)
        block = att["proj"] + att["qk_pv"] + TR.mlp_flops(cfg, batch, seq)
        down = 2 * batch * seq * cfg.d_ff * cfg.d_model
        return cfg.n_layers * {"none": 0, "dots": att["qk_pv"],
                               "full": block - down}[mode]

    def onehot(cfg):
        # the one-hot embedding gradient is one more bwd matmul where it
        # is eligible (neither granite's nor minitron's table at full width)
        return (2 * batch * seq * cfg.vocab_padded * cfg.d_model
                if embed_grad_eligible(torch.empty(batch, seq,
                                                   device="meta"),
                                       cfg.vocab_padded) else 0)

    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device)
    g4 = dataclasses.replace(granite, n_layers=layers)
    fwd_mm = TR.matmul_flops(g4, batch, seq)
    model_flops = 6 * g4.param_count() * batch * seq
    print(f"== 4h. main path: the dense family. granite-8b at full width "
          f"(d_model {g4.d_model}, {g4.n_heads}/{g4.n_kv_heads} heads x "
          f"{g4.head_dim}, d_ff {g4.d_ff}, vocab {g4.vocab_size}), {layers} "
          f"of {granite.n_layers} layers ({g4.param_count() / 1e9:.3f} B "
          f"params), seq {seq} batch {batch} amp O1 fusion static, einsum "
          f"attention, remat none / dots / full (fwd matmul FLOPs must be "
          f"{fwd_mm}; MODEL_FLOPS 6·N·T = {model_flops})")
    peaks, losses = {}, {}
    for mode in ("none", "dots", "full"):
        t0 = time.perf_counter()
        prof = s.profile("granite-8b", phases=("fwd", "bwd"), remat=mode,
                         smoke=smoke, n_layers=layers, seq=seq, batch=batch,
                         amp="O1", fusion="static", measure=True, iters=3,
                         warmup=1)
        want = {"fwd": fwd_mm,
                "bwd": 3 * fwd_mm + onehot(g4) + recompute(g4, mode)}
        for ph in ("fwd", "bwd"):
            mm, _ = phase_summary(mode, ph, prof, sheet)
            if mm != want[ph]:
                raise AssertionError(f"granite remat={mode} {ph}: matmul "
                                     f"FLOPs {mm} != {want[ph]}")
        ana = prof.analyses["bwd"]
        peaks[mode] = prof.data["bwd"].peak_device_bytes
        losses[mode] = float(prof.data["fwd"].output)
        print(f"  remat {mode:<4}: fwd loss {losses[mode]:.7f} | bwd peak "
              f"device memory {peaks[mode] / 1e9:.3f} GB | bwd walk "
              f"{ana.total_flops:.0f} FLOPs, recompute "
              f"{recompute(g4, mode)} matmul FLOPs | model_flops_ratio "
              f"{model_flops_ratio(model_flops, ana, 1):.4f} | profile "
              f"call {time.perf_counter() - t0:.1f} s")
        del prof, ana
        empty_cache()
    if not all(math.isfinite(v) for v in losses.values()) or \
            max(losses.values()) - min(losses.values()) > \
            1e-6 * abs(losses["none"]):
        raise AssertionError(f"granite fwd losses differ by remat: {losses}")
    if cuda and not peaks["none"] > peaks["dots"] > peaks["full"]:
        raise AssertionError(f"bwd peak memory is not none > dots > full: "
                             f"{peaks}")

    model = M.build(g4)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init(model.spec, gen, torch.float32, device)
    batch_t = M.synthetic_batch(g4, ShapeSpec("t", seq, batch, "train"),
                                batch, gen, device)

    def grads(mode):
        run = RunConfig(amp="O1", fusion="static", remat=mode)
        return tree_flatten(make_phases(model, run)["bwd"](params,
                                                           batch_t))[0]

    base = grads("none")
    for mode in ("dots", "full"):
        worst = 0.0
        for a, b in zip(grads(mode), base):
            worst = max(worst, float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
        print(f"  remat {mode} gradients against none's: largest "
              f"|difference| / the leaf's max|g| {worst:.3e} (tolerance "
              f"{REMAT_GRAD_TOL:g})")
        if not worst <= REMAT_GRAD_TOL:
            raise AssertionError(f"remat {mode} gradients differ by {worst}")
        empty_cache()
    del base
    if cuda:
        remat_held_check(model, params, batch_t, g4, batch * seq)
    before = kernels.launch_counts()["flash_attention"]
    with torch.no_grad():
        loss = float(model.loss_fn(params, batch_t, RunConfig(
            amp="O1", fusion="static", attn_impl="flash"))[0])
    launched = kernels.launch_counts()["flash_attention"] - before
    print(f"  flash fwd: loss {loss:.7f} (einsum {losses['none']:.7f}), "
          f"flash launches {launched} (one a layer, G = "
          f"{g4.n_heads // g4.n_kv_heads})")
    if not math.isfinite(loss) or (cuda and launched != layers):
        raise AssertionError(f"granite flash fwd: loss {loss}, {launched} "
                             "launches")
    del params, batch_t, model
    empty_cache()

    # minitron-4b, full depth, Adafactor and remat full
    mlayers = minitron.n_layers if minitron_layers is None else \
        minitron_layers
    mc = dataclasses.replace(minitron, n_layers=mlayers)
    m_fwd = TR.matmul_flops(mc, batch, seq)
    unembed = 2 * batch * seq * mc.d_model * mc.vocab_padded
    print(f"  minitron-4b at full width (d_model {mc.d_model}, "
          f"{mc.n_heads}/{mc.n_kv_heads} heads, d_ff {mc.d_ff}, act "
          f"{mc.act}, vocab {mc.vocab_size}), {mlayers} of "
          f"{minitron.n_layers} layers ({mc.param_count() / 1e9:.3f} B "
          f"params: f32 params and grads take "
          f"{8 * mc.param_count() / 1e9:.1f} GB; AdamW's moments would add "
          f"{8 * mc.param_count() / 1e9:.1f}), optimizer adafactor, remat "
          f"full (fwd matmul FLOPs must be {m_fwd}, the unembedding "
          f"{unembed} of them)")
    kw = dict(smoke=smoke, n_layers=mlayers, seq=seq, batch=batch,
              amp="O1", fusion="static", remat="full",
              optimizer="adafactor", measure=True, iters=3, warmup=1)
    want = {"fwd": m_fwd, "bwd": 3 * m_fwd + onehot(mc)
            + recompute(mc, "full"), "opt": 0}
    for phases in (("fwd", "bwd"), ("opt",)):
        t0 = time.perf_counter()
        prof = s.profile("minitron-4b", phases=phases, **kw)
        for ph in phases:
            mm, _ = phase_summary("minitron", ph, prof, sheet)
            if mm != want[ph]:
                raise AssertionError(f"minitron {ph}: matmul FLOPs {mm} != "
                                     f"{want[ph]}")
            if ph == "fwd" and not any(
                    k.total_flops == unembed and k.category == "matmul"
                    for k in prof.analyses[ph].kernels):
                raise AssertionError("minitron fwd: no unembedding record")
        print(f"  minitron {'/'.join(phases)} profile call "
              f"{time.perf_counter() - t0:.1f} s")
        del prof
        empty_cache()
    run = RunConfig(amp="O1", fusion="static", remat="full",
                    optimizer="adafactor")
    model = M.build(mc)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    opt_bytes = sum(t.numel() * t.element_size() for t in tree_flatten(
        (state.opt.vr, state.opt.vc, state.opt.v))[0])
    share = opt_bytes / (8 * mc.param_count())
    print(f"  Adafactor state {opt_bytes} B against AdamW's 8·N = "
          f"{8 * mc.param_count()} B ({share:.2e} of it)")
    step = make_train_step(model, run)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        batch_t = M.synthetic_batch(mc, ShapeSpec("t", seq, batch, "train"),
                                    batch, gen, device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_t)
        sync()
        loss = float(metrics["loss"])
        print(f"  minitron adafactor train step {i + 1}: loss {loss:.6f} | "
              f"grad norm {float(metrics['grad_norm']):.4f} | "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
        if not math.isfinite(loss):
            raise AssertionError(f"minitron step {i + 1}: loss {loss}")
    if cuda:
        print(f"  minitron train steps: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, step, model, batch_t
    empty_cache()

    # mistral-large-123b: the op walk on meta tensors, full width and depth
    t0 = time.perf_counter()
    prof = Session(machine=sheet, device=device).profile(
        "mistral-large-123b", phases=("fwd",), smoke=smoke, seq=seq,
        batch=batch, amp="O1")
    mm = sum(k.total_flops for k in prof.analyses["fwd"].kernels
             if k.category == "matmul")
    want_mm = TR.matmul_flops(mistral, batch, seq)
    print(f"  mistral-large-123b fwd walk on meta tensors ({mistral.n_layers}"
          f" layers, d_model {mistral.d_model}): matmul FLOPs {mm:.0f} "
          f"(analytic {want_mm}); param_count {mistral.param_count()} "
          f"(the reference's {MISTRAL_PARAMS}); walk "
          f"{time.perf_counter() - t0:.1f} s")
    if mm != want_mm or (not smoke and mistral.param_count() !=
                         MISTRAL_PARAMS):
        raise AssertionError(f"mistral-large-123b: matmul FLOPs {mm} != "
                             f"{want_mm} or param_count "
                             f"{mistral.param_count()}")
    del prof
    counts = kernels.launch_counts()
    print(f"launches on main path h: {json.dumps(counts)}")
    for name in ("fused_rmsnorm", "fused_rmsnorm_residual", "fused_swiglu",
                 "flash_attention"):
        if cuda and counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on main "
                                 "path h")
    return counts


def serving_checks(dev, sheet) -> list[dict]:
    """Phase 3 at the shapes serving gives the kernels (rows of step 3's
    table, not of the JSON line): a prefill chunk of 256 tokens and a
    decode tick over 8 slots of glm4-9b (path i) and granite-moe-1b-a400m
    (path k) — flash on the chunk, causal, at (1, 256, 2 KV heads x 16,
    128) and (1, 256, 8 x 2, 64); the norms at (8, d) and (256, d), d 4096
    and 1024; glm4-9b's SwiGLU at (8, 13696) and (256, 13696).  Each is
    held against its plain version at its existing tolerance and timed
    through a replayed CUDA graph beside its bound and the library call
    (``F.rms_norm``, SDPA).  Flash's bound counts each input read once: q
    and o for the query heads, k and v for the KV heads.  Then the fp32
    norms of the O0 decode checks: path j's at batch 2 and 8 — (B, 2048),
    the layer and final norms of mamba2-1.3b and zamba2-1.2b and zamba2's
    residual seam, and (B, 4096), mamba2's gated norm over d_inner — and
    path l's seamless-m4t-large-v2 at width 1024: its decode step (2
    rows), its decoder forward (32) and its encoder (512)."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import config as kc
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.fused import norm, swiglu

    g = torch.Generator(device=dev).manual_seed(5)
    bf16, f32, eps = torch.bfloat16, torch.float32, 1e-5

    def randn(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    def ulp(ref) -> float:
        # one bf16 rounding at the largest |ref| (fused_checks' bound)
        return 2.0 ** -7 * ref.float().abs().max().item() + 1e-30

    print("serving shapes (paths i and k: glm4-9b and granite-moe-1b-a400m, "
          "a 256-token prefill chunk and a decode tick over 8 slots; "
          "tolerances as above: the norms and SwiGLU 1 bf16 ulp at max|ref|, "
          "flash ref.kernel_tolerance)")
    rows = []

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.flatten(2, 3).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), is_causal=True, enable_gqa=True)

    for (d, f, shape), who in (((4096, 13_696, (1, 256, 2, 16, 128)),
                                "glm4-9b, path i"),
                               ((1024, None, (1, 256, 8, 2, 64)),
                                "granite-moe-1b-a400m, path k")):
        b, s, kv, grp, hd = shape
        sets, nxt = rotating(lambda: (randn(shape), randn((b, s, kv, hd)),
                                      randn((b, s, kv, hd))), k=4)
        q, k, v = sets[0]
        want = fops._ref_gqa(q, k, v, True)
        err = check_within(f"flash[{fk.route(hd, bf16)}] prefill chunk "
                           f"{'x'.join(map(str, shape))} bf16 causal ({who})",
                           fk.flash_attention_grouped(q, k, v), want,
                           fref.kernel_tolerance(want))
        flop = fk.flops(b * kv * grp, s, s, hd)
        r = shape_row(
            "flash_attention", f"bf16 q {shape}, causal (the prefill chunk, "
            f"{who})", err, lambda: fk.flash_attention_grouped(*nxt()),
            lambda: fops._ref_gqa(*nxt(), True), lambda: sdpa(*nxt()),
            bound(2 * 2 * b * s * (kv * grp + kv) * hd, flop, "bf16", sheet),
            kc.resolve("flash_attention", None).dict)
        r["extra"] = (f"{fk.route(hd, bf16)} kernel, "
                      f"{r['ms'] / r['library_ms']:.3f}x SDPA")
        rows.append(r)
        del sets, q, k, v, want
        for rows_n, tick in ((8, "decode tick"), (256, "prefill chunk")):
            sets, nxt = rotating(lambda: (randn((rows_n, d), 3.0),
                                          randn((rows_n, d))))
            x, h = sets[0]
            sc = torch.rand((4, d), generator=g, device=dev)[1]
            want = norm.rmsnorm_ref(x, sc, eps, bf16)
            err = check(f"rmsnorm bf16 {rows_n}x{d} ({tick}, {who})",
                        norm.fused_rmsnorm(x, sc), want, ulp(want))
            rows.append(shape_row(
                "fused_rmsnorm", f"bf16 ({rows_n}, {d}), f32 scale ({tick}, "
                f"{who})", err, lambda: norm.fused_rmsnorm(nxt()[0], sc),
                lambda: norm.rmsnorm_ref(nxt()[0], sc, eps, bf16),
                lambda: F.rms_norm(nxt()[0], (d,), sc, eps),
                bound(norm.hbm_bytes(rows_n, d, 2), norm.flops(rows_n, d),
                      "f32", sheet),
                launch_config("fused_norm", x, (rows_n, d))))
            r_ref, y_ref = norm.rmsnorm_residual_ref(x, h, sc, eps, bf16)
            rr, yy = norm.fused_rmsnorm_residual(x, h, sc)
            check(f"rmsnorm_residual r bf16 {rows_n}x{d}", rr, r_ref, 0.0)
            err = check(f"rmsnorm_residual y bf16 {rows_n}x{d} ({tick}, "
                        f"{who})", yy, y_ref, ulp(y_ref))
            rows.append(shape_row(
                "fused_rmsnorm_residual", f"bf16 ({rows_n}, {d}) x and h "
                f"({tick}, {who})", err,
                lambda: norm.fused_rmsnorm_residual(*nxt(), sc),
                lambda: norm.rmsnorm_residual_ref(*nxt(), sc, eps, bf16),
                None,
                bound(norm.hbm_bytes(rows_n, d, 2, residual=True),
                      norm.flops(rows_n, d, residual=True), "f32", sheet),
                launch_config("fused_norm", x, (rows_n, d))))
            del sets, x, h
            if f is None:       # granite-moe's experts: plain silu(g)·u
                continue
            sets, nxt = rotating(lambda: (randn((rows_n, f), 2.0),
                                          randn((rows_n, f))))
            a, bb = sets[0]
            want = swiglu.swiglu_ref(a, bb, "silu", bf16)
            err = check(f"swiglu silu bf16 {rows_n}x{f} ({tick}, {who})",
                        swiglu.fused_swiglu(a, bb), want, ulp(want))
            rows.append(shape_row(
                "fused_swiglu", f"bf16 ({rows_n}, {f}), silu ({tick}, "
                f"{who})", err, lambda: swiglu.fused_swiglu(*nxt()),
                lambda: swiglu.swiglu_ref(*nxt(), "silu", bf16), None,
                bound(swiglu.hbm_bytes(rows_n, f, 2),
                      swiglu.flops(rows_n, f), "f32", sheet),
                launch_config("fused_swiglu", a, (rows_n, f))))
            del sets, a, bb
    print("decode shapes (path j: mamba2-1.3b and zamba2-1.2b at O0; path "
          "l: seamless-m4t-large-v2's O0 decode; tolerance as fused_checks' "
          "fp32: 8 f32 ulps at max|ref|, r = x + h exactly)")

    def f32_tol(ref) -> float:
        return 8 * 2.0 ** -22 * ref.abs().max().item() + 1e-30

    decode = {}
    for rows_n, d in itertools.product((2, 8), (2048, 4096)):
        decode[rows_n, d] = ("layer and final norms, zamba2's residual seam, "
                             "path j" if d == 2048 else
                             "mamba2's gated norm, path j")
    # seamless's decode check at batch 2: the step, the forward over 16
    # tokens and the encoder over 256 frames
    for rows_n, who in ((2, "decode step"), (32, "decoder forward"),
                        (512, "encoder")):
        decode[rows_n, 1024] = f"seamless-m4t-large-v2's {who}, path l"
    for (rows_n, d), who in decode.items():
        sets, nxt = rotating(lambda: (randn((rows_n, d), 3.0, f32),
                                      randn((rows_n, d), 1.0, f32)))
        x, h = sets[0]
        sc = torch.rand((4, d), generator=g, device=dev)[1]
        want = norm.rmsnorm_ref(x, sc, eps, f32)
        err = check(f"rmsnorm f32 {rows_n}x{d} ({who})",
                    norm.fused_rmsnorm(x, sc), want, f32_tol(want))
        rows.append(shape_row(
            "fused_rmsnorm", f"f32 ({rows_n}, {d}), f32 scale ({who})", err, lambda: norm.fused_rmsnorm(nxt()[0], sc),
            lambda: norm.rmsnorm_ref(nxt()[0], sc, eps, f32),
            lambda: F.rms_norm(nxt()[0], (d,), sc, eps),
            bound(norm.hbm_bytes(rows_n, d, 4), norm.flops(rows_n, d),
                  "f32", sheet),
            launch_config("fused_norm", x, (rows_n, d))))
        r_ref, y_ref = norm.rmsnorm_residual_ref(x, h, sc, eps, f32)
        rr, yy = norm.fused_rmsnorm_residual(x, h, sc)
        check(f"rmsnorm_residual r f32 {rows_n}x{d}", rr, r_ref, 0.0)
        err = check(f"rmsnorm_residual y f32 {rows_n}x{d} ({who})", yy,
                    y_ref, f32_tol(y_ref))
        rows.append(shape_row(
            "fused_rmsnorm_residual", f"f32 ({rows_n}, {d}) x and h "
            f"({who})", err,
            lambda: norm.fused_rmsnorm_residual(*nxt(), sc),
            lambda: norm.rmsnorm_residual_ref(*nxt(), sc, eps, f32), None,
            bound(norm.hbm_bytes(rows_n, d, 4, residual=True),
                  norm.flops(rows_n, d, residual=True), "f32", sheet),
            launch_config("fused_norm", x, (rows_n, d))))
        del sets, x, h
    torch.cuda.empty_cache()
    return rows


#: path i's call: glm4-9b at full width and depth served by the
#: continuous-batching engine (the session's arguments)
SERVE_ARGS = dict(smoke=False, amp="O1", fusion="static", trace="poisson",
                  n_requests=16, rate=1.0, seed=0, n_slots=8, max_len=2048,
                  prefill_chunk=256, page_size=16, prompt_len=(64, 1024),
                  max_new=(16, 64))
#: the kernels on the serving path, by their op in the walk
SERVE_KERNELS = {"flash_attention": "flash_attention",
                 "fused_rmsnorm": "rmsnorm",
                 "fused_rmsnorm_residual": "rmsnorm_residual",
                 "fused_swiglu": "swiglu"}
#: path i's logits against ``forward_fn``'s, both O1 (bf16 logits from
#: two lowerings of the same function: chunked prefill with flash and
#: paged attention against one causal einsum pass), and ``static``'s
#: against ``off``'s: the log-partition (logsumexp over the vocab, the
#: loss's own reduction) within this relative difference, path e's bound
#: on its loss; an H100 read at most 2.1e-5 on path i and 1.139e-4 on
#: path k, where the top logit (about 7.77, its bf16 spacing 2^-5) holds
#: 3.8% of the softmax and rounds to either side: 0.038 x 2^-5 / 11.04 =
#: 1.09e-4 (path k's experts replayed, so routing plays no part)
SERVE_LSE_RTOL = 2e-4
#: and each logit within this many bf16 ulps at the largest |logit|: an
#: H100 read at most 1.45 (one rounding of each logit, and of the hidden
#: state before it, in other places)
SERVE_LOGIT_ULPS = 4


def _spy_request(eng, prompt, max_new: int):
    """Serve one more request alone through ``eng`` (its slot 0), keeping
    what each executable returned (``Engine.keep_logits``): (the first
    token's logits — the last prefill chunk's —, the logits of each
    decode tick's slot 0, the tokens, the prefill chunks)."""
    from repro_torch.serve.engine import Request

    eng.logits.clear()
    eng.keep_logits = True
    try:
        req = Request(uid=-1, prompt=prompt, max_new=max_new)
        eng.serve([req])
    finally:
        eng.keep_logits = False
    seen, eng.logits = eng.logits, []
    if req.finish_reason != "length":
        raise AssertionError(f"the rerun finished {req.finish_reason}")
    prefill = [lg for name, lg in seen if name != "decode"]
    decode = [lg[0] for name, lg in seen if name == "decode"]
    return prefill[-1], decode, req.out, len(prefill)


def _logits_check(label: str, got, ref, vocab: int) -> tuple[float, float]:
    """Hold one position's logits over the vocab: their logsumexp within
    :data:`SERVE_LSE_RTOL` (relative) and every logit within
    :data:`SERVE_LOGIT_ULPS` bf16 ulps at the largest |logit|; prints
    whether the greedy token agrees.  Returns (relative logsumexp
    difference, max |error|)."""
    import torch
    got, ref = got[:vocab].float(), ref[:vocab].float()
    lse_got, lse_ref = float(torch.logsumexp(got, 0)), float(
        torch.logsumexp(ref, 0))
    rel = abs(lse_got - lse_ref) / abs(lse_ref)
    err, scale = max_abs_err(got, ref)
    atol = SERVE_LOGIT_ULPS * 2.0 ** -7 * scale
    top = int(torch.argmax(ref))
    same = int(torch.argmax(got)) == top
    ok = rel <= SERVE_LSE_RTOL and err <= atol and math.isfinite(err)
    # one bf16 rounding of the top logit moves the logsumexp by its
    # softmax share times its spacing (2^(e-8) for a value m·2^e)
    p_top = float(torch.softmax(ref, 0)[top])
    one = p_top * 2.0 ** (math.frexp(float(ref[top]))[1] - 8) / abs(lse_ref)
    print(f"  {label:<44} logsumexp {lse_got:.6f} vs {lse_ref:.6f}: rel "
          f"{rel:.3e} (rtol {SERVE_LSE_RTOL:g}; one bf16 ulp of the top "
          f"logit, softmax share {p_top:.4f}: {one:.3e}) | max_abs_err "
          f"{err:.3e} (tol {atol:.3e}, max|ref| {scale:.3e}, "
          f"{err / (2.0 ** -7 * scale):.2f} ulps) | greedy token "
          f"{'same' if same else 'DIFFERS'}  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: logsumexp rel {rel}, max_abs_err "
                             f"{err}")
    return rel, err


def _walls_line(eng) -> str:
    """Each executable's calls and per-call walls in ms (host clock, to
    ``torch.cuda.synchronize``): the first (it pays what is set up on
    first use in the process), the median and the least."""
    import statistics
    return " | ".join(
        f"{name} {len(w)} calls, first {w[0] * 1e3:.3f}, median "
        f"{statistics.median(w) * 1e3:.3f}, least {min(w) * 1e3:.3f}"
        for name, w in eng.call_walls.items() if w)


def serve_path(sheet, *, device: str = "cuda", arch: str = "glm4-9b",
               kernels: dict | None = None, path: str = "i",
               **overrides) -> dict:
    """Main path i: ``Session.serve`` of glm4-9b at full width and depth
    (40 layers, 9.40 B params in fp32) under :data:`SERVE_ARGS` — 16
    Poisson requests, prompts of 64-1024 tokens, 16-64 new tokens each, 8
    slots over a paged KV pool of 2048 tokens a slot, 256-token prefill
    chunks, O1, ``static`` (``overrides`` rehearse it on the host at the
    smoke size).  Launch counts are set to 0 just before the call and
    read just after; then it holds:

    1. every request finished by ``length``; ``cache.check()``; every
       page back on the free-list;
    2. the launches of flash, ``fused_rmsnorm``, ``fused_rmsnorm_residual``
       and ``fused_swiglu`` above 0, and each equal to the walk's count
       per call of each executable times its calls;
    3. the ``serve/glm4-9b`` record read back by ``Session.report`` under
       its run id, with ``prefill`` and ``decode`` phases; each phase's
       FLOPs, HBM bytes, arithmetic intensity and share of its bound;
    4. request 0 served again alone: its first-token logits (the
       ``prefill_first`` and ``prefill_ext`` chunks) and the next 4
       tokens' (decode ticks) against ``forward_fn`` over the prompt and
       the generated prefix; the trace served again by an engine at
       ``off`` on the same parameters (every request done by
       ``length``; its per-call walls beside ``static``'s), and request 0
       through it: its first-token logits against ``static``'s
       (:func:`_logits_check`);
    5. on the card, the share of a rerun's wall in which the card ran a
       kernel (:func:`busy_share`).

    ``kernels`` names the kernels the trace must launch (default
    :data:`SERVE_KERNELS`).  A MoE model (path k) holds request 0 by
    :func:`moe_first_token` and :func:`moe_against_off` in 4, on replayed
    experts: its logits follow the engine's routing groups, not one
    forward's, and a near-tie can route two lowerings apart.

    Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.session.session import Session

    args = {**SERVE_ARGS, **overrides}
    cuda = torch.device(device).type == "cuda"
    want_kernels = SERVE_KERNELS if kernels is None else kernels
    print(f"== 4{path}. main path: serve {arch} (Session.serve: "
          f"{json.dumps(args)})")
    K.reset_launch_counts()
    s = Session(machine=sheet, device=device)
    t0 = time.perf_counter()
    res = s.serve(arch, **args)
    counts = K.launch_counts()
    took = time.perf_counter() - t0
    rec, stats, eng, reqs = res.data
    cfg = eng.cfg
    print(f"  {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.2f} B params in fp32 "
          f"({4 * cfg.param_count() / 1e9:.1f} GB); KV pool "
          f"{eng.cache.n_pages} pages of {eng.cache.page_size} "
          f"({2 * eng.cache.k_pool.numel() * 2 / 1e9:.3f} GB bf16); prefill "
          f"chunk {eng.chunk}, flash on the first chunk: "
          f"{eng.prefill_first_flash}; Session.serve {took:.1f} s")
    print(res.text)
    # 1. the run
    reasons = sorted({r.finish_reason for r in reqs})
    if res.exit_code or stats.n_completed != args["n_requests"] \
            or reasons != ["length"]:
        raise AssertionError(f"serve: {stats.n_completed} of "
                             f"{args['n_requests']} completed, finished by "
                             f"{reasons}; gate {stats.gate()}")
    eng.cache.check()
    if sorted(eng.cache.free) != list(range(eng.cache.n_pages)):
        raise AssertionError("serve: pages still owned after the trace")
    sm = rec.meta["serve"]
    print(f"  all {sm['completed']} requests done by length in "
          f"{sm['ticks']} ticks, {sm['new_tokens']} new tokens; every page "
          f"free")
    # 2. launches against the walk
    walk = {name: 0 for name in want_kernels}
    for exe, ana in res.analyses.items():
        per = {name: sum(k.exec_count for k in ana.kernels
                         if k.opcode == op)
               for name, op in want_kernels.items()}
        print(f"  walk of {exe}: {eng.calls[exe]} calls, "
              f"{eng.wall[exe] / eng.calls[exe] * 1e3:.3f} ms a call, "
              f"per call {json.dumps(per)}, "
              f"{sum(k.exec_count for k in ana.kernels)} launches")
        for name in walk:
            walk[name] += per[name] * eng.calls[exe]
    static_walls = _walls_line(eng)
    print(f"launches on main path {path} (serving): {json.dumps(counts)} "
          f"(the walk: {json.dumps(walk)})")
    for name in want_kernels:
        if walk[name] <= 0 or (cuda and counts[name] != walk[name]):
            raise AssertionError(f"serve: {name} launched {counts[name]} "
                                 f"times, the walk says {walk[name]}")
    # 3. the record, read back; the phases against the roofline
    back = s.report(f"serve/{arch}")
    if back.data.run_id != rec.run_id or set(back.phases) != {"prefill",
                                                              "decode"}:
        raise AssertionError(f"report read {back.data.run_id} "
                             f"{sorted(back.phases)}, wrote {rec.run_id}")
    print(f"  TTFT p50 {sm['ttft_p50_s'] * 1e3:.3f} ms, p99 "
          f"{sm['ttft_p99_s'] * 1e3:.3f} ms | per-token p50 "
          f"{sm['tpot_p50_s'] * 1e3:.3f} ms, p99 "
          f"{sm['tpot_p99_s'] * 1e3:.3f} ms | {sm['tokens_per_s']:.2f} "
          f"tokens/s | ms per decode tick "
          f"{eng.wall['decode'] / eng.calls['decode'] * 1e3:.3f} | ms per "
          f"prefill chunk "
          f"{(eng.wall['prefill_first'] + eng.wall['prefill_ext']) / (eng.calls['prefill_first'] + eng.calls['prefill_ext']) * 1e3:.3f}"
          f" (report read back run {rec.run_id})")
    for ph, p in rec.phases.items():
        ai = p["flops"] / p["hbm_bytes"] if p["hbm_bytes"] else 0.0
        print(f"  phase {ph:<8} {p['iters']} calls, wall "
              f"{p['wall_s'] * 1e3:.3f} ms | FLOPs {p['flops']:.4e} | HBM "
              f"bytes {p['hbm_bytes']:.4e} | AI {ai:.2f} FLOP/B | bound "
              f"{p['bound_overlap_s'] * 1e3:.3f} ms ({p['dominant']}) | "
              f"{100 * p['pct_of_roofline']:.2f}% of bound | launches "
              f"{p['launches']} ({p['zero_ai_launches']} zero-AI)")
    # 4. request 0 again, against forward_fn and against fusion off
    req0 = next(r for r in reqs if r.uid == 0)
    n_dec = 4
    moe = cfg.family == "moe"
    if moe:
        prompt, first, dec, toks, calls = moe_first_token(eng, req0.prompt,
                                                          n_dec, device)
    else:
        prompt = req0.prompt
        first, dec, toks, chunks = _spy_request(eng, prompt, n_dec + 1)
        seq = torch.as_tensor(np.concatenate([prompt, toks[:n_dec]]),
                              dtype=torch.int32, device=device)
        P = len(prompt)
        with torch.inference_mode():
            full = eng.model.forward_fn(eng.params, {"tokens": seq[None]},
                                        eng.run)[0, P - 1:]
        print(f"  request 0 served again alone: prompt {P} tokens in "
              f"{chunks} chunks, tokens {toks} (in the trace, beside other "
              f"slots: {req0.out[:n_dec + 1]}); against forward_fn over the "
              f"prompt and the generated prefix ({P + n_dec} tokens, the "
              f"same run)")
        _logits_check("first token (prefill_first + prefill_ext)", first,
                      full[0], cfg.vocab_size)
        for i, lg in enumerate(dec[:n_dec]):
            _logits_check(f"decoded token {i + 1} (decode tick)", lg,
                          full[i + 1], cfg.vocab_size)
        del full
    off = Engine(cfg, RunConfig(amp=args["amp"], fusion="off"), eng.params,
                 n_slots=eng.n_slots, max_len=eng.max_len,
                 page_size=eng.cache.page_size, prefill_chunk=eng.chunk,
                 device=device)
    again = [Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                     arrival=r.arrival) for r in reqs]
    st_off = off.run_trace(again)
    if st_off.n_completed != args["n_requests"] \
            or {r.finish_reason for r in again} != {"length"}:
        raise AssertionError(f"serve at off: {st_off.n_completed} of "
                             f"{args['n_requests']} completed")
    same = sum(a.out == r.out for a, r in zip(again, reqs))
    print(f"  the trace again at fusion off, same parameters: "
          f"{st_off.n_completed} requests in {st_off.ticks} ticks, "
          f"{st_off.wall_s:.3f} s (static {stats.wall_s:.3f} s), "
          f"{st_off.tokens_per_s:.2f} tokens/s; {same} of {len(reqs)} "
          f"requests with static's tokens exactly")
    print(f"  per-call walls, ms, static: {static_walls}")
    print(f"  per-call walls, ms, off:    {_walls_line(off)}")
    if moe:
        moe_against_off(off, prompt, first, dec, toks, calls, n_dec)
    else:
        first_off = _spy_request(off, prompt, 1)[0]
        _logits_check("first token, static against off", first, first_off,
                      cfg.vocab_size)
    del off
    # no torch.profiler window for path k: it runs before j and i, whose
    # host clocks a profiled window would slow
    if cuda and not moe:
        busy_share(eng, prompt, n_dec)
    del res, eng
    return counts


def _routing_diff(label: str, pairs, K: int) -> int:
    """Print where two runs' routing differs.  ``pairs`` holds, for each
    routing call in order, (experts a, experts b, probs b) over the same
    real tokens — (T, K), (T, K), (T, E).  For each call, the tokens whose
    top-k sets differ; for those, b's relative margin at the cut,
    ``(p_K - p_K+1) / p_K``, against the median over all tokens.  Equal
    top-k sets in every call give equal kept sets too: the ranks inside an
    expert, and so the capacity drops, follow from the sets.  Returns the
    number of (call, token) flips."""
    import torch
    flips, margins, first, med = [], [], None, []
    for i, (ea, eb, pb) in enumerate(pairs):
        differ = (torch.sort(ea, -1).values
                  != torch.sort(eb, -1).values).any(-1)
        top = torch.topk(pb.float(), K + 1, dim=-1).values
        rel = (top[:, K - 1] - top[:, K]) / top[:, K - 1]
        med.append(rel)
        flips.append(int(differ.sum()))
        if flips[-1]:
            margins.append(float(rel[differ].max()))
            first = i if first is None else first
    med = float(torch.cat(med).median())
    n = sum(flips)
    worst = (f"; their margins in b at most {max(margins):.3e}, at the "
             f"first such call ({first}) at most {margins[0]:.3e}"
             if n else "")
    print(f"  routing, {label}: {n} of {sum(len(p[0]) for p in pairs)} "
          f"(call, token) top-k sets differ; per call {flips}; median "
          f"margin at the cut {med:.3e}{worst}")
    return n


def _free_gap(label: str, got, ref, vocab: int) -> None:
    """Print (not held) the gap between two logit vectors."""
    import torch
    lse = [float(torch.logsumexp(t[:vocab].float(), 0)) for t in (got, ref)]
    err, scale = max_abs_err(got[:vocab].float(), ref[:vocab].float())
    same = int(got[:vocab].argmax()) == int(ref[:vocab].argmax())
    print(f"  (not held) {label}: logsumexp rel "
          f"{abs(lse[0] - lse[1]) / abs(lse[1]):.3e}, max_abs_err {err:.3e} "
          f"({err / (2.0 ** -7 * scale):.2f} bf16 ulps at max|ref|), greedy "
          f"token {'same' if same else 'differs'}")


def moe_first_token(eng, prompt, n_dec: int, device):
    """Path k's check against ``forward_fn``.  A MoE block routes each
    group of tokens with its own capacity, and the engine's groups are
    its calls: a prefill chunk (its padded tail included) or one decode
    slot's token.  So the request is the prompt's first chunk served
    alone (``n_dec`` + 1 tokens), under a :class:`~moe.RoutingTape`, and
    its first-token logits are held against ``forward_fn`` over the same
    chunk padded as the engine pads it (zeros after the prompt; the stable
    sort puts the padding behind the prompt in every expert and the causal
    mask hides it) with the engine's experts replayed: the same discrete
    choices, rounding alone between them, under :func:`_logits_check`'s
    bounds.  The same forward routing on its own is compared and its
    routing diffed (:func:`_routing_diff`), not held: where the two
    lowerings round a near-tie differently they pick other experts.  So is
    the forward over the unpadded prompt, one group of another capacity.
    Returns (the prompt chunk, the first-token and decode-tick logits,
    the tokens, the tape's calls)."""
    import numpy as np
    import torch
    from repro_torch.models import moe as MOE

    cfg, C, L = eng.cfg, eng.chunk, eng.cfg.n_layers
    prompt = np.asarray(prompt[:C], np.int32)
    P = len(prompt)
    with MOE.RoutingTape() as tape:
        first, dec, toks, chunks = _spy_request(eng, prompt, n_dec + 1)
    padded = np.zeros(C, np.int32)
    padded[:P] = prompt
    fwd = eng.model.forward_fn
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(padded, device=device)[None]}
        with MOE.RoutingTape(replay=tape.calls[:L]):
            pinned = fwd(eng.params, batch, eng.run)[0, P - 1]
        with MOE.RoutingTape() as free:
            grouped = fwd(eng.params, batch, eng.run)[0, P - 1]
        whole = fwd(eng.params, {"tokens": torch.as_tensor(
            prompt, device=device)[None]}, eng.run)[0, P - 1]
    print(f"  request 0's first {P} prompt tokens served alone ({chunks} "
          f"chunk of {C}: one routing group, capacity "
          f"{MOE._capacity(C, cfg)}; {n_dec} decode ticks, each slot's token "
          f"a group), tokens {toks}; against forward_fn over the chunk as "
          f"the engine pads it, on the engine's experts")
    _routing_diff("engine's chunk against forward_fn's own", [
        (a["experts"][0, :P], b["experts"][0, :P], b["probs"][0, :P])
        for a, b in zip(tape.calls[:L], free.calls)], cfg.experts_per_token)
    _free_gap("against forward_fn's own routing over the padded chunk",
              first, grouped, cfg.vocab_size)
    _free_gap(f"against forward_fn over the {P} unpadded tokens, one group "
              f"at capacity {MOE._capacity(P, cfg)}", first, whole,
              cfg.vocab_size)
    _logits_check("first token (prefill_first), engine's experts", first,
                  pinned, cfg.vocab_size)
    return prompt, first, dec, toks, tape.calls


def moe_against_off(off, prompt, first, dec, toks, calls, n_dec: int
                    ) -> None:
    """Path k's check of ``static`` against ``off``: the prompt chunk of
    :func:`moe_first_token` served alone again by the engine at
    ``fusion="off"``, replaying the ``static`` run's experts (``calls``):
    its first-token logits and each decode tick's held against
    ``static``'s under :func:`_logits_check`'s bounds, the ticks while the
    two runs' greedy tokens (each tick's input) agree.  Then once more on
    its own routing: the routing diffed over the prompt's tokens and slot
    0's decode tokens, and the first token's gap printed, not held."""
    import torch
    from repro_torch.models import moe as MOE

    cfg, L, P = off.cfg, off.cfg.n_layers, len(prompt)
    with torch.inference_mode(), MOE.RoutingTape(replay=calls):
        first_o, dec_o, toks_o, _ = _spy_request(off, prompt, n_dec + 1)
    print(f"  the same request at fusion off on static's experts: tokens "
          f"{toks_o} (static {toks})")
    _logits_check("first token, static against off", first, first_o,
                  cfg.vocab_size)
    held = 0
    for i in range(n_dec):
        if toks_o[:i + 1] != toks[:i + 1]:
            break
        _logits_check(f"decoded token {i + 1}, static against off", dec[i],
                      dec_o[i], cfg.vocab_size)
        held += 1
    print(f"  {held} of {n_dec} decode ticks held (a tick is held while its "
          f"input token agrees)")
    with torch.inference_mode(), MOE.RoutingTape() as free:
        first_f = _spy_request(off, prompt, n_dec + 1)[0]
    # the chunk's calls, then one a layer each decode tick (slot 0's token)
    pairs = [(a["experts"][0, :P], b["experts"][0, :P], b["probs"][0, :P])
             if i < L else (a["experts"][0], b["experts"][0],
                            b["probs"][0])
             for i, (a, b) in enumerate(zip(calls, free.calls))]
    _routing_diff("static against off, each on its own", pairs,
                  cfg.experts_per_token)
    _free_gap("first token, static against off, each on its own routing",
              first, first_f, cfg.vocab_size)


def busy_share(eng, prompt, n_dec: int) -> None:
    """Where the serving wall goes: request 0 served alone once more
    under ``torch.profiler`` (CUDA activity only, so the host is not
    slowed by CPU tracing): the share of its wall in which a kernel ran
    on the card, and the kernels that took the most device time, each
    with its share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _spy_request(eng, prompt, n_dec + 1)
        wall = time.perf_counter() - t0
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    dev_s = sum(e.self_device_time_total for e in ev) / 1e6
    top = ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                    f" x{e.count} "
                    f"({e.self_device_time_total / 1e4 / dev_s:.1f}%)"
                    for e in ev[:4])
    print(f"  request 0 alone under torch.profiler (its prefill chunks "
          f"and {n_dec} decode ticks): wall {wall * 1e3:.3f} ms, kernels "
          f"on the card {dev_s * 1e3:.3f} ms: busy {100 * dev_s / wall:.1f}%"
          f", idle {100 * (1 - dev_s / wall):.1f}%; most device time: "
          f"{top}")


#: path j's duality bound: each decode step's logits against the
#: forward's at that position, both fp32 (O0), the recurrence against the
#: chunked scan summing in another order.  An H100 read at most 2.3e-5
#: (mamba2-1.3b) and 1.1e-5 (zamba2-1.2b) over 64 steps; the bound is
#: the port's O0 logits tolerance (tests/test_torch_model.py), under the
#: reference's own 5e-2 for the SSD duality (tests/test_models.py:152)
DECODE_DUALITY_ATOL = 1e-4


def decode_path(cfgs, sheet, *, device: str = "cuda", layers=None,
                batch: int = 2, prompt: int = 64, time_batches=(2, 8),
                smoke: bool = False) -> dict:
    """Main path j: the SSM and hybrid decode steps at full width and
    depth (mamba2-1.3b, 48 layers; zamba2-1.2b, 38 layers and 6 sites), O0
    (fp32), ``fusion="static"`` (the fused rmsnorm at the few-row decode
    shapes: (B, 2048) and the gated (B, d_inner); the hybrid's residual
    seam too).  For each: a ``prompt``-token prompt fed one token at a
    time through ``decode_fn`` from a zero state (the hybrid's window
    fp32 and as long as the prompt), each step's logits held against
    ``forward_fn`` over the prompt (:data:`DECODE_DUALITY_ATOL`); then
    one decode step timed at each batch of ``time_batches``, eager (host
    clock, synchronized) and replayed from a CUDA graph, against its bound
    (the fp32 weights and the state read, the state written).  Launch
    counts are set to 0 just before and read just after."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import api as M
    from repro_torch.models.params import init
    from torch.utils._pytree import tree_flatten

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = RunConfig(amp="O0", fusion="static")
    print(f"== 4j. main path: SSM and hybrid decode at full width, O0, "
          f"static; a {prompt}-token prompt one token at a time against "
          f"the forward (atol {DECODE_DUALITY_ATOL:g}: fp32 sums in "
          f"another order; the reference's SSD duality bound is 5e-2)")
    kernels.reset_launch_counts()
    for cfg in cfgs:
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = M.build(cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        params = init(model.spec, gen, torch.float32, device)
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                               generator=gen, device=device,
                               dtype=torch.int32)

        def fresh(b):
            if cfg.family == "hybrid":
                return model.init_state_fn(b, prompt, torch.float32,
                                           device=device)
            return model.init_state_fn(b, device=device)

        with torch.inference_mode():
            full = model.forward_fn(params, {"tokens": tokens}, run)
            state, worst = fresh(batch), (0.0, 0)
            for t in range(prompt):
                lg, state = model.decode_fn(
                    params, {"tokens": tokens[:, t:t + 1]}, state, run)
                err = (lg[:, 0] - full[:, t]).abs().max().item()
                worst = max(worst, (err, t))
        scale = full.abs().max().item()
        ok = worst[0] <= DECODE_DUALITY_ATOL and math.isfinite(worst[0])
        print(f"  {cfg.name}: {cfg.n_layers} layers, "
              f"{cfg.param_count() / 1e9:.3f} B params; {prompt} decode "
              f"steps at batch {batch} against the forward: max_abs_err "
              f"{worst[0]:.3e} at step {worst[1]} (max|ref| {scale:.3e}, "
              f"atol {DECODE_DUALITY_ATOL:g})  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{cfg.name} decode against the forward: "
                                 f"{worst}")
        del full, state, lg
        w_bytes = sum(t.numel() * t.element_size()
                      for t in tree_flatten(params)[0])
        for b in time_batches:
            st = fresh(b)
            s_bytes = sum(t.numel() * t.element_size()
                          for t in tree_flatten(tuple(st))[0])
            tok = tokens[:1, :1].expand(b, 1).contiguous()

            def step():
                return model.decode_fn(params, {"tokens": tok}, st, run)

            with torch.inference_mode():
                for _ in range(3):
                    step()
                sync()
                t0 = time.perf_counter()
                for _ in range(10):
                    step()
                sync()
                eager = (time.perf_counter() - t0) / 10 * 1e3
                graph = graph_ms(step, calls=10) if cuda else float("nan")
            bnd = bound(w_bytes + 2 * s_bytes, 0.0, "f32", sheet)
            print(f"  {cfg.name} decode step at batch {b}: eager "
                  f"{eager:.3f} ms (host clock) | graph-replayed "
                  f"{graph:.3f} ms | bound {bnd['bound_ms']:.3f} ms "
                  f"({bnd['bound_by']}: {w_bytes / 1e9:.3f} GB of fp32 "
                  f"weights, {s_bytes / 1e6:.2f} MB of state read and "
                  f"written) | {100 * bnd['bound_ms'] / graph:.1f}% of bound "
                  f"replayed")
            del st
        del params, model
        if cuda:
            torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    print(f"launches on main path j: {json.dumps(counts)}")
    for name in ("fused_rmsnorm", "fused_rmsnorm_residual"):
        if cuda and counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on main "
                                 "path j")
    return counts


def family_train(arch: str, sheet, *, device: str = "cuda",
                 layers: int | None = None, seq: int = 2048, batch: int = 2,
                 smoke: bool = False, iters: int = 5, warmup: int = 2,
                 label: str, adamw_row: bool = False
                 ) -> tuple[dict, list[dict]]:
    """One train step of a registry config (paths k and l) at O1,
    ``fusion="static"``, ``attn_impl="flash"`` (``layers`` cuts the
    depth, keeping the widths):

    1. the fwd, bwd and opt phases profiled with ``measure=True``, each
       wall beside the walk's bound: the fwd's matmul FLOPs equal
       ``transformer.matmul_flops`` less the QKᵀ and PV of every causal
       self-attention (the encoder's too), which flash takes — a MoE's
       experts at the capacity-padded E·C slots, a cross-attention's
       products in the count; flash launched once a self-attention in
       each fwd pass, ``fused_adamw`` once an opt call, its walk record
       the per-leaf sums;
    2. 3 steps of ``make_train_step``, each with a finite loss (and its
       aux, for a MoE), and the peak memory;
    3. with ``adamw_row``, the AdamW launch held and timed on the
       model's leaves (a row of step 3's table).

    Launch counts are set to 0 just before and read just after; returns
    them and the rows."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import api as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TR
    from repro_torch.models.params import leaves
    from repro_torch.session.session import Session
    from repro_torch.train.step import init_state, make_train_step

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    layers = cfg.n_layers if layers is None else layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    H, hd = cfg.n_heads, cfg.head_dim
    mem = seq // TR.FRAME_DOWNSAMPLE
    selfs = [(layers, seq)] + ([(cfg.n_encoder_layers, mem)]
                               if cfg.n_encoder_layers else [])
    qk_pv = sum(n * TR.attention_flops(cfg, batch, s)["qk_pv"]
                for n, s in selfs)
    want_mm = TR.matmul_flops(cfg, batch, seq) - qk_pv
    want_flash = sum(n * fk.flops(batch * H, s, s, hd) for n, s in selfs)
    n_self = sum(n for n, _ in selfs)
    numels = [math.prod(p.shape) for _, p in leaves(M.build(cfg).spec)]
    extra = ""
    if cfg.family == "moe":
        extra = (f"; {cfg.n_experts} experts top-{cfg.experts_per_token} "
                 f"of d_ff {cfg.d_ff}, capacity C = "
                 f"{MOE._capacity(seq, cfg)} a group of {seq} tokens")
    if cfg.family == "vlm":
        extra = (f"; {cfg.n_prefix_embeds} patch embeddings before "
                 f"{seq - cfg.n_prefix_embeds} tokens")
    if cfg.n_encoder_layers:
        extra = (f"; encoder {cfg.n_encoder_layers} layers over {mem} "
                 f"frames, cross-attention in every decoder layer")
    print(f"  {label}: {cfg.name} train step, {layers} layers, d_model "
          f"{cfg.d_model}, heads {H}/{cfg.n_kv_heads} x {hd}, act "
          f"{cfg.act}, vocab {cfg.vocab_size}{extra}; {sum(numels)} params "
          f"in the spec tree (params, grads and both AdamW moments in fp32: "
          f"{16 * sum(numels) / 1e9:.1f} GB); seq {seq} batch {batch} O1 "
          f"static flash (fwd matmul FLOPs must be {want_mm}, flash "
          f"{want_flash:.0f})")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device=device)
    t0 = time.perf_counter()
    prof = s.profile(arch, smoke=smoke, n_layers=layers, seq=seq,
                     batch=batch, amp="O1", fusion="static",
                     attn_impl="flash", measure=True, iters=iters,
                     warmup=warmup)
    got = kernels.launch_counts()
    for ph in ("fwd", "bwd", "opt"):
        mm, fa = phase_summary(label, ph, prof, sheet)
        if ph == "fwd" and (mm != want_mm or fa != want_flash):
            raise AssertionError(f"{cfg.name} fwd: matmul FLOPs {mm} != "
                                 f"{want_mm} or flash {fa} != {want_flash}")
    passes = 2 * (warmup + iters)       # the fwd and bwd phases' fwd passes
    print(f"  launches in the profile: flash {got['flash_attention']} "
          f"(expected {passes * n_self}: {n_self} self-attentions a pass "
          f"over {passes} passes), fused_adamw {got['fused_adamw']}; "
          f"profile call {time.perf_counter() - t0:.1f} s")
    if cuda and got["flash_attention"] != passes * n_self:
        raise AssertionError(f"{cfg.name}: flash launched "
                             f"{got['flash_attention']} times")
    check_adamw_walk(f"{cfg.name} opt", prof.analyses["opt"], numels,
                     got["fused_adamw"], warmup + iters, cuda)
    del prof
    if cuda:
        torch.cuda.empty_cache()

    run = RunConfig(amp="O1", fusion="static", attn_impl="flash")
    model = M.build(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    step = make_train_step(model, run)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        batch_t = M.synthetic_batch(cfg, ShapeSpec("t", seq, batch,
                                                   "train"), batch, gen,
                                    device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_t)
        sync()
        loss = float(metrics["loss"])
        aux = (f" (ce {float(metrics['ce']):.6f} + 0.01 x aux "
               f"{float(metrics['aux']):.6f})" if "aux" in metrics else "")
        print(f"  {cfg.name} train step {i + 1}: loss {loss:.6f}{aux} | "
              f"grad norm {float(metrics['grad_norm']):.4f} | "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
        if not math.isfinite(loss):
            raise AssertionError(f"{cfg.name} train step {i + 1}: loss "
                                 f"{loss}")
    if cuda:
        print(f"  train steps: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del step, batch_t
    counts = kernels.launch_counts()
    rows = ([adamw_leaves_row(state.params, sheet, f"{cfg.name}, {label}")]
            if cuda and adamw_row else [])
    del state
    if cuda:
        torch.cuda.empty_cache()
    return counts, rows


def need_launched(counts: dict, names, path: str, cuda: bool) -> None:
    if cuda:
        for name in names:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"main path {path}")


#: the MoE serving path's kernels, by their op in the walk: granite-moe's
#: routed experts compute silu(g)·u in plain ops, as the reference's
#: (``src/repro/models/moe.py:118``), so fused_swiglu does not run
MOE_SERVE_KERNELS = {k: v for k, v in SERVE_KERNELS.items()
                     if k != "fused_swiglu"}
#: the parameters of kimi-k2-1t-a32b (the reference's ``param_count``)
KIMI_PARAMS = 1_043_853_440_000


def moe_path(sheet, *, device: str = "cuda", smoke: bool = False,
             train: dict | None = None, serve: dict | None = None,
             kimi: dict | None = None) -> tuple[dict, list[dict]]:
    """Main path k: the MoE family.

    1. granite-moe-1b-a400m's train step at full width and depth (24
       layers, 32 experts top-8, seq 2048, batch 2, O1, ``static``,
       flash; :func:`family_train`): its phases against the walk's bound,
       the experts at E·C = 32 x 640 slots in the walk's matmul FLOPs,
       3 steps with their aux loss, the AdamW launch on its leaves;
    2. ``Session.serve`` of path i's trace on granite-moe
       (:func:`serve_path`): 16 of 16 requests done, the allocator
       clean, flash and the norms launched as the walk says;
    3. kimi-k2-1t-a32b's fwd walk on meta tensors at full width and
       depth (61 layers, 384 experts, a shared expert; its fp32 weights,
       about 4 TB, fit no card): matmul FLOPs equal the count.

    ``train`` / ``serve`` / ``kimi`` override the keywords of each part
    (a host rehearsal at the smoke size).  Returns the launch counts of
    1 and 2 and the AdamW row."""
    import torch
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.models import transformer as TR
    from repro_torch.session.session import Session

    cuda = torch.device(device).type == "cuda"
    print("== 4k. main path: the MoE family (granite-moe-1b-a400m trained "
          "and served; kimi-k2-1t-a32b's walk)")
    counts, rows = family_train("granite-moe-1b-a400m", sheet, device=device,
                                smoke=smoke, label="path k",
                                adamw_row=True, **(train or {}))
    need_launched(counts, ("flash_attention", "fused_rmsnorm",
                           "fused_rmsnorm_residual", "fused_adamw"), "k",
                  cuda)
    served = serve_path(sheet, device=device, arch="granite-moe-1b-a400m",
                        kernels=MOE_SERVE_KERNELS, path="k",
                        **(serve or {}))
    kw = {"seq": 2048, "batch": 2, **(kimi or {})}
    cfg = get_smoke("kimi-k2-1t-a32b") if smoke else get_config(
        "kimi-k2-1t-a32b")
    t0 = time.perf_counter()
    prof = Session(machine=sheet, device=device).profile(
        "kimi-k2-1t-a32b", smoke=smoke, phases=("fwd",), amp="O1", **kw)
    ana = prof.analyses["fwd"]
    mm = sum(k.total_flops for k in ana.kernels if k.category == "matmul")
    want = TR.matmul_flops(cfg, kw["batch"], kw["seq"])
    print(f"  kimi-k2-1t-a32b fwd walk on meta: {cfg.n_layers} layers, "
          f"{cfg.n_experts} experts top-{cfg.experts_per_token} and a "
          f"shared expert of {cfg.moe_shared_ff}; param_count "
          f"{cfg.param_count()} ({cfg.active_param_count()} active a "
          f"token); seq {kw['seq']} batch {kw['batch']}: matmul FLOPs "
          f"{mm:.0f} (analytic {want}), total {ana.total_flops:.0f}, HBM "
          f"bytes {ana.total_hbm_bytes:.0f}, "
          f"{sum(k.exec_count for k in ana.kernels)} launches; "
          f"{time.perf_counter() - t0:.1f} s")
    if mm != want or (not smoke and cfg.param_count() != KIMI_PARAMS):
        raise AssertionError(f"kimi walk: matmul FLOPs {mm} != {want}, or "
                             f"param_count {cfg.param_count()}")
    print(f"launches on main path k: train {json.dumps(counts)}, serve "
          f"{json.dumps(served)}")
    return {k: counts[k] + served[k] for k in counts}, rows


#: path l's seamless decode against its forward, both fp32 (O0): each
#: step's logits within the port's O0 logits tolerance
#: (tests/test_torch_model.py)
ENCDEC_DECODE_ATOL = 1e-4


def multimodal_path(sheet, *, device: str = "cuda", smoke: bool = False,
                    vlm_fwd: dict | None = None, vlm_train: dict | None = None,
                    audio_train: dict | None = None, decode_steps: int = 16,
                    decode_frames: int = 256) -> tuple[dict, list[dict]]:
    """Main path l: the VLM and the encoder-decoder.

    1. phi-3-vision-4.2b's fwd at full width and depth (32 layers, 576
       patch embeddings in a 2048-token sequence, batch 2, O1,
       ``static``, flash): its wall against the walk's bound, matmul
       FLOPs equal to the count less the QKᵀ and PV flash takes (the
       unembedding over the 1472 tokens), flash once a layer a pass;
    2. its train step cut to 4 layers (:func:`family_train`; at 32 layers
       its 3.72 B fp32 params, gradients and AdamW moments take about 60
       GB before any activation);
    3. seamless-m4t-large-v2's train step at full width and depth (24 +
       24 layers, 256 encoder frames, seq 2048, batch 2; flash on both
       stacks' self-attention, never on the cross-attention);
    4. seamless's decode: ``decode_steps`` tokens one at a time through
       ``decode_fn`` against the encoder's memory of ``decode_frames``
       frames, from a zero fp32 cache, O0, ``static``: each step's logits
       within :data:`ENCDEC_DECODE_ATOL` of ``forward_fn`` over the same
       frames and tokens, and of the same steps at ``fusion="off"`` (its
       launches are not counted); a step timed.

    Returns the launch counts and rows."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.models import api as M
    from repro_torch.models import transformer as TR
    from repro_torch.models.params import init
    from repro_torch.session.session import Session
    from torch.utils._pytree import tree_flatten

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    vlm, audio = "phi-3-vision-4.2b", "seamless-m4t-large-v2"
    print("== 4l. main path: the VLM (phi-3-vision-4.2b) and the enc-dec "
          "(seamless-m4t-large-v2)")
    kernels.reset_launch_counts()
    kw = {"seq": 2048, "batch": 2, "iters": 3, "warmup": 1,
          **(vlm_fwd or {})}
    cfg = get_smoke(vlm) if smoke else get_config(vlm)
    B, S = kw["batch"], kw["seq"]
    want_mm = TR.matmul_flops(cfg, B, S) - cfg.n_layers * \
        TR.attention_flops(cfg, B, S)["qk_pv"]
    t0 = time.perf_counter()
    prof = Session(machine=sheet, device=device).profile(
        vlm, smoke=smoke, phases=("fwd",), amp="O1", fusion="static",
        attn_impl="flash", measure=True, **kw)
    got = kernels.launch_counts()
    print(f"  {vlm} fwd at full width and depth: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}; {cfg.param_count() / 1e9:.3f} B params in "
          f"fp32; {cfg.n_prefix_embeds} patches + "
          f"{S - cfg.n_prefix_embeds} tokens, batch {B}; loss "
          f"{float(prof.data['fwd'].output):.6f}; profile call "
          f"{time.perf_counter() - t0:.1f} s")
    mm, _ = phase_summary("path l", "fwd", prof, sheet)
    passes = kw["iters"] + kw["warmup"]
    if mm != want_mm or (cuda and got["flash_attention"]
                         != passes * cfg.n_layers):
        raise AssertionError(f"{vlm} fwd: matmul FLOPs {mm} != {want_mm}, "
                             f"or flash launched {got['flash_attention']}")
    if not math.isfinite(float(prof.data["fwd"].output)):
        raise AssertionError(f"{vlm} fwd loss is not finite")
    counts = kernels.launch_counts()
    del prof
    if cuda:
        torch.cuda.empty_cache()
    rows = []
    for arch, kw_t in ((vlm, {"layers": 4, **(vlm_train or {})}),
                       (audio, dict(audio_train or {}))):
        got, r = family_train(arch, sheet, device=device, smoke=smoke,
                              label="path l", iters=3, warmup=1, **kw_t)
        counts = {k: counts[k] + got[k] for k in counts}
        rows += r

    # 4. the enc-dec decode against its forward
    kernels.reset_launch_counts()
    cfg = get_smoke(audio) if smoke else get_config(audio)
    run = RunConfig(amp="O0", fusion="static")
    model = M.build(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init(model.spec, gen, torch.float32, device)
    T = decode_steps
    tokens = torch.randint(0, cfg.vocab_size, (2, T), generator=gen,
                           device=device, dtype=torch.int32)
    frames = (torch.randn((2, decode_frames, cfg.d_model), generator=gen,
                          device=device) * 0.02).to(torch.bfloat16)
    def decode(run, walls=None):
        memory = TR.encode(params, frames, cfg, run)
        state = model.init_state_fn(2, T, torch.float32, device=device)
        out = []
        for t in range(T):
            sync()
            t0 = time.perf_counter()
            lg, state = model.decode_fn(
                params, {"tokens": tokens[:, t:t + 1], "memory": memory},
                state, run)
            sync()
            if walls is not None:
                walls.append(time.perf_counter() - t0)
            out.append(lg[:, 0])
        return torch.stack(out, 1)

    walls = []
    with torch.inference_mode():
        full = model.forward_fn(params, {"tokens": tokens,
                                         "frames": frames}, run)
        steps = decode(run, walls)
        dec = kernels.launch_counts()
        steps_off = decode(RunConfig(amp="O0", fusion="off"))
    err = (steps - full).abs().amax((0, 2))
    worst = (err.max().item(), int(err.argmax()))
    err_off = (steps - steps_off).abs().amax((0, 2))
    worst_off = (err_off.max().item(), int(err_off.argmax()))
    scale = full.abs().max().item()
    ok = all(w <= ENCDEC_DECODE_ATOL and math.isfinite(w)
             for w in (worst[0], worst_off[0]))
    w_bytes = sum(t.numel() * t.element_size()
                  for t in tree_flatten(params)[0])
    print(f"  {audio} decode, O0 static: {T} steps at batch 2 against an "
          f"encoder memory of {decode_frames} frames, each step's logits "
          f"against forward_fn over the same frames and tokens: "
          f"max_abs_err {worst[0]:.3e} at step {worst[1]} (max|ref| "
          f"{scale:.3e}, atol {ENCDEC_DECODE_ATOL:g}); against the same "
          f"steps at fusion off (the plain norms): max_abs_err "
          f"{worst_off[0]:.3e} at step {worst_off[1]}  "
          f"{'ok' if ok else 'MISMATCH'}; a step {min(walls) * 1e3:.3f} ms "
          f"least, {sorted(walls)[len(walls) // 2] * 1e3:.3f} ms median "
          f"(host clock, synchronized; {w_bytes / 1e9:.3f} GB of fp32 "
          f"weights: bound "
          f"{bound(w_bytes, 0.0, 'f32', sheet)['bound_ms']:.3f} ms)")
    if not ok:
        raise AssertionError(f"{audio} decode against the forward: {worst}, "
                             f"against fusion off: {worst_off}")
    del params, full, steps, steps_off
    if cuda:
        torch.cuda.empty_cache()
    counts = {k: counts[k] + dec[k] for k in counts}
    print(f"launches on main path l: {json.dumps(counts)}")
    need_launched(counts, ("flash_attention", "fused_rmsnorm",
                           "fused_rmsnorm_residual", "fused_swiglu",
                           "fused_adamw"), "l", cuda)
    return counts, rows


#: the learning rate of ``make_train_step``'s default
LR = 3e-4


def smoke_checks(dev, arch: str, fwd_runs: dict, step_run,
                 kink_share: float = 0.0) -> None:
    """Step 5 for one registry config at its smoke size (seq 32, batch 4):
    the fwd at each of ``fwd_runs`` and one train step at ``step_run``, on
    the card against the same functions on the host (the port's CPU path,
    which the tests hold against the JAX reference; a routed kernel runs
    on the card, its plain version on the host).  The params after the
    step agree within 2e-5, but for at most ``kink_share`` of their
    elements, which must agree within 2·lr: where a relu's input lies
    within rounding of 0, the card and the host may put it on either
    side, which moves the gradient of every weight before it, and AdamW's
    first step (about lr·sign(g)) turns a small change in a near-zero
    gradient into up to 2·lr."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import api as M
    from repro_torch.models.params import init
    from repro_torch.train.step import TrainState, init_state, make_train_step
    from torch.utils._pytree import tree_flatten, tree_map

    scfg = get_smoke(arch)
    model = M.build(scfg)
    gen = torch.Generator().manual_seed(0)
    params = init(model.spec, gen, torch.float32, "cpu")
    batch_c = M.synthetic_batch(scfg, ShapeSpec("s", 32, 4, "train"), 4, gen)
    # copies: the train step updates its state in place
    params_d, batch_d = tree_map(lambda t: t.to(dev, copy=True),
                                 (params, batch_c))
    for label, run in fwd_runs.items():
        with torch.no_grad():
            lc = model.forward_fn(params, batch_c, run)
            lg = model.forward_fn(params_d, batch_d, run).cpu()
            loss_c = model.loss_fn(params, batch_c, run)[0].item()
            loss_g = model.loss_fn(params_d, batch_d, run)[0].item()
        check(f"{arch} smoke logits at {label}: card vs host", lg, lc, 1e-4)
        print(f"  {arch} smoke loss at {label}: card {loss_g:.7f} host "
              f"{loss_c:.7f}")
        if not math.isclose(loss_g, loss_c, rel_tol=1e-5):
            raise AssertionError(f"{arch} smoke loss {loss_g} vs host "
                                 f"{loss_c}")
    st_c = init_state(model, step_run, torch.Generator().manual_seed(0),
                      "cpu")
    st_d = TrainState(*tree_map(lambda t: t.to(dev, copy=True),
                                tuple(st_c)))
    step = make_train_step(model, step_run)
    st_c, m_c = step(st_c, batch_c)
    st_d, m_d = step(st_d, batch_d)
    print(f"  {arch} smoke train step ({step_run.amp}, fusion "
          f"{step_run.fusion}, attn {step_run.attn_impl}, ssd "
          f"{step_run.ssd_impl}, impl {step_run.impl}, remat "
          f"{step_run.remat}, {step_run.optimizer}): loss card "
          f"{float(m_d['loss']):.7f} host "
          f"{float(m_c['loss']):.7f}; grad norm card "
          f"{float(m_d['grad_norm']):.7f} host {float(m_c['grad_norm']):.7f}")
    if not math.isclose(float(m_d["loss"]), float(m_c["loss"]),
                        rel_tol=1e-5):
        raise AssertionError(f"{arch} smoke train loss differs between card "
                             "and host")
    diff = torch.cat([(a.cpu().double() - b.double()).abs().ravel()
                      for a, b in zip(tree_flatten(st_d.params)[0],
                                      tree_flatten(st_c.params)[0])])
    err, past = float(diff.max()), int((diff > 2e-5).sum())
    allowed = int(kink_share * diff.numel())
    print(f"  {arch} smoke params after one step: max_abs_err {err:.3e} "
          f"(atol 2e-5); {past} of {diff.numel()} elements past it "
          f"(allowed {allowed}, each within 2·lr = {2 * LR:g})")
    if past > allowed or not err <= max(2e-5, 2 * LR if allowed else 0):
        raise AssertionError(f"{arch} smoke params differ by {err} "
                             f"({past} elements past 2e-5)")


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
    # every path runs in one workspace, emptied here: its tune store starts
    # empty, so step 3 and paths a-d launch the default configs whatever a
    # tune.json elsewhere (./.repro-workspace) holds, and path e's first
    # tune pass times
    workspace = os.path.join(ROOT, "build", "chip_workspace")
    shutil.rmtree(workspace, ignore_errors=True)
    os.makedirs(workspace)
    os.environ["REPRO_WORKSPACE"] = workspace
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
    from repro_torch.tune.store import active_store

    # 1. the card ----------------------------------------------------------
    gpu = describe_gpu()
    dev = torch.device("cuda", 0)
    print(f"== 1. card: {gpu['smi']} | capability {gpu['capability']} | "
          f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)")
    sheet = datasheet_for(gpu["name"])
    print(machine_table(sheet))

    # 2. build -------------------------------------------------------------
    print("== 2. build (one nvcc per source, started together)")
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        built = dict(zip(LIBRARIES, ex.map(
            lambda name: build.build(name, verbose=True), LIBRARIES)))
    for name, (path, secs) in built.items():
        print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s")

    # 3. each kernel against its plain version -----------------------------
    store = active_store()
    print("== 3. kernels against their plain versions (datasheet "
          f"{sheet.name}; tune store {store.path}, "
          f"{len(list(store.keys()))} records)")
    if store.path != os.path.join(workspace, "tune.json") or \
            list(store.keys()):
        raise AssertionError(f"step 3 reads the tune store {store.path}, "
                             "not the emptied workspace's")
    rows = kernel_checks(dev, sheet)
    torch.cuda.empty_cache()
    rows += fused_checks(dev, sheet)
    rows += layernorm_checks(dev, sheet)
    rows += flash_checks(dev, sheet)
    rows += ssd_checks(dev, sheet)
    rows += serving_checks(dev, sheet)
    for r in rows:
        lib = r["library_ms"]
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        eager = (f" (called eagerly back to back: {r['eager_ms']:.4f} ms)"
                 if "eager_ms" in r else "")
        print(f"  {r['name']:<22} {r['shape']}: kernel {r['ms']:.4f} ms"
              f"{eager} | plain {r['plain_ms']:.4f} ms | library {lib_s} | "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | config "
              f"{r['config']}{' | ' + r['extra'] if 'extra' in r else ''}")
    torch.cuda.empty_cache()

    # 4a. main path: machine characterization and the full-depth fwd -------
    print("== 4a. main path: characterize, ladder, sweep, full-width profile")
    kernels.reset_launch_counts()
    s = Session(machine=sheet, device="cuda")
    res = s.characterize(empirical=True, tuned=False)
    print(res.render())
    lad = ops.ladder("cuda")
    for k, v in lad.items():
        print(f"  ladder {k:<32} {v / 1e12:9.2f} TFLOP/s")
    sweep = ops.gemm_size_sweep(device="cuda")
    for size, v in sweep.items():
        # the yardstick, timed as the sweep times the kernel (a replayed
        # CUDA graph, the least of 3 samples) on the same operands
        a, b = ops.gemm_operands(size, size, size, torch.bfloat16, dev)
        lib = 2.0 * size ** 3 / ops.time_gemm(lambda: torch.matmul(a, b),
                                              dev)
        print(f"  gemm sweep {size:>5}^3 bf16 {v / 1e12:9.2f} TFLOP/s | "
              f"torch.matmul {lib / 1e12:9.2f} TFLOP/s | config "
              f"{launch_config('ert_gemm', a, (size,) * 3)}")
        del a, b
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
    print(f"launches on main path a: {json.dumps(counts)}")
    for name in ERT_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on main "
                                 "path a")
    del prof, pr
    torch.cuda.empty_cache()

    # 4b. main path: the train step at full width, 4 layers -----------------
    counts_b = train_path(cfg, sheet)
    torch.cuda.empty_cache()

    # 4c. main path: the same step at flash attention, record and report ----
    counts_c = attention_path(cfg, sheet, workspace=workspace)
    torch.cuda.empty_cache()

    # 4d. main path: mamba2-1.3b at full width, both SSD routes, train step --
    counts_d = ssm_path(get_config("mamba2-1.3b"), sheet)
    torch.cuda.empty_cache()

    # 4e. main path: tuning, tuned ceilings, the dispatch table, auto --------
    counts_e = tuning_path(cfg, sheet, meas, workspace=workspace)
    torch.cuda.empty_cache()

    # 4f. main path: DeepCAM at the paper's resolution, both lowerings -------
    deepcam_path(get_config("deepcam"), sheet, meas, workspace=workspace)
    torch.cuda.empty_cache()

    # 4g. main path: the zamba2-1.2b hybrid at full width and depth ---------
    counts_g, rows_g = hybrid_path(get_config("zamba2-1.2b"), sheet)
    rows += rows_g
    torch.cuda.empty_cache()

    # 4h. main path: granite remat, minitron Adafactor, mistral's walk ------
    counts_h = dense_family_path(get_config("granite-8b"),
                                 get_config("minitron-4b"),
                                 get_config("mistral-large-123b"), sheet)
    torch.cuda.empty_cache()

    # 4l. main path: phi-3-vision's fwd and step, seamless's step and decode
    counts_l, rows_l = multimodal_path(sheet)
    rows += rows_l
    torch.cuda.empty_cache()

    # 4k. main path: granite-moe trained and served, kimi-k2's walk --------
    counts_k, rows_k = moe_path(sheet)
    rows += rows_k
    torch.cuda.empty_cache()

    # 4j. main path: the SSM and hybrid decode steps at full width ----------
    # (before path i, which ends under torch.profiler: eager host time
    # read after a profiled window doubled on an H100 host)
    decode_path((get_config("mamba2-1.3b"), get_config("zamba2-1.2b")),
                sheet)
    torch.cuda.empty_cache()

    # 4i. main path: glm4-9b served at full width by the engine -----------
    serve_path(sheet)
    torch.cuda.empty_cache()
    for r in rows_g + rows_l + rows_k:
        print(f"  {r['name']:<22} {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3e} | kernel {r['ms']:.4f} ms | "
              f"plain {r['plain_ms']:.4f} ms | library "
              f"{r['library_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) | config {r['config']}")

    # 5. the smoke fwd and train step on the card against the host -----------
    from repro_torch.configs.base import RunConfig
    print("== 5. smoke fwd and train step: card against host (O0 loss rtol "
          "1e-5, logits atol 1e-4: fp32 sums in another order; params after "
          "one step atol 2e-5: AdamW's first step is about lr·sign(g), so a "
          "near-zero gradient summed in another order moves its weight by "
          "up to 2·lr·|Δg|/(|g|+eps); see tests/test_torch_train.py)")
    smoke_checks(dev, "glm4-9b",
                 {"einsum": RunConfig(amp="O0"),
                  "flash (kernel on the card)": RunConfig(
                      amp="O0", attn_impl="flash")},
                 RunConfig(amp="O0", fusion="static"))
    smoke_checks(dev, "mamba2-1.3b",
                 {"ssd kernel (kernel on the card)": RunConfig(
                     amp="O0", ssd_impl="kernel")},
                 RunConfig(amp="O0", fusion="static", ssd_impl="kernel"))
    # DeepCAM's 60 relus: on the host the fused lowering's fp32 step puts
    # one relu input on the other side of 0 from its fp64 step, and 12 of
    # 670,805 params then differ by more than 2e-5 (at most 1.25e-4); an
    # H100 read 1.07e-4 against the host
    for impl in ("reference", "fused"):
        smoke_checks(dev, "deepcam",
                     {impl: RunConfig(amp="O0", impl=impl)},
                     RunConfig(amp="O0", fusion="static", impl=impl),
                     kink_share=1e-4)
    smoke_checks(dev, "zamba2-1.2b",
                 {"ssd kernel + flash (kernels on the card)": RunConfig(
                     amp="O0", ssd_impl="kernel", attn_impl="flash")},
                 RunConfig(amp="O0", fusion="static", ssd_impl="kernel",
                           attn_impl="flash"))
    smoke_checks(dev, "minitron-4b", {"einsum": RunConfig(amp="O0")},
                 RunConfig(amp="O0", fusion="static", optimizer="adafactor"))
    smoke_checks(dev, "granite-8b", {"einsum": RunConfig(amp="O0")},
                 RunConfig(amp="O0", fusion="static", remat="dots"))
    # the MoE, VLM and enc-dec families (paths k and l)
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                 "phi-3-vision-4.2b", "seamless-m4t-large-v2"):
        smoke_checks(dev, arch,
                     {"einsum": RunConfig(amp="O0"),
                      "flash (kernel on the card)": RunConfig(
                          amp="O0", attn_impl="flash")},
                     RunConfig(amp="O0", fusion="static", attn_impl="flash"))

    # 6. results -------------------------------------------------------------
    out = []
    for r in rows:
        if r.get("at_shape"):
            continue             # a new path's shape: step 3's table only
        launches = (counts if r["name"] in ERT_KERNELS else
                    counts_c if r["name"] in FLASH_KERNELS else
                    counts_d if r["name"] in SSD_KERNELS else
                    counts_e if r["name"] in TUNE_KERNELS else counts_b)
        out.append({k: r[k] for k in ("name", "route", "source", "replaces")}
                   | {"launches": launches[r["name"]],
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
