"""Check and time the multi-tensor AdamW kernel on one CUDA card, and
profile the host side of one DeepCAM opt call.

Builds ``src/repro_torch/kernels/csrc/fused.cu`` alone (printing the
``ptxas`` register, shared-memory and spill report), then runs
``chip_smoke.adamw_checks``: the one-leaf call at its odd shapes, the
multi-tensor launch against ``adamw_ref`` on DeepCAM's 370 leaves (O1 and
O2 moments, in place and not), views at odd offsets, the split past one
launch's table and two dtype groups, the timing line of the 370 leaves
(the launch, the loop of one-leaf launches, ``torch._fused_adamw_``, the
bound) and the f32 unembed leaf's row::

    python tools/adamw_check.py                  # check, then time
    python tools/adamw_check.py --profile        # and the host profile
    python tools/adamw_check.py --profile-only   # the profile alone

``--profile`` runs DeepCAM's opt phase (``make_phases(...)["opt"]``, stem
width 64, AMP O1, ``fusion="static"``, in place, as path f of
``chip_smoke.py`` runs it) 20 times on the card and splits each call's
host time in place: a host-clock wrapper around each function that does
a part — the tree walk of ``adamw_update``, the bias corrections, the
routing (``use_adamw`` per leaf), the custom-op dispatch (the routed
call less the kernel wrapper it reaches), the tune-store lookups
(``for_launch``), the wrapper's checks, pointers, table and launches
(less the lookups), the wait for the card at the end — and the rest;
medians over the calls, and the kernel's launches a call.
``--profile-only`` uses only names a tree from before the multi-tensor
kernel has too (there ``adamw_leaf`` / ``fused_adamw`` per leaf), so it
splits that tree's opt call the same way.  Exits 1 on the first
mismatch.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile(device: str = "cuda", width: int = 64, calls: int = 20) -> None:
    """The host split of one DeepCAM opt call (see the module doc): each
    part timed in place, inside the calls, by a host-clock wrapper
    around the function that does it; medians over ``calls``."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_map

    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import config as kc
    from repro_torch.kernels.fused import adamw as ak
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.models import api as M
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_phases

    cfg = get_config("deepcam")
    if cfg.d_model != width:
        raise ValueError(f"the registry's deepcam is width {cfg.d_model}")
    run = RunConfig(amp="O1", fusion="static")
    model = M.build(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, run, gen, device)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=device), state.params)
    opt = make_phases(model, run)["opt"]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    # (module, function): one launch a leaf before the multi-tensor kernel
    multi = hasattr(ak, "fused_adamw_multi")
    timed = {"walk": [(optim, n) for n in ("tree_flatten", "tree_unflatten",
                                           "_leaves_like")
                      if hasattr(optim, n)],
             "bias": [(optim, "bias_corrections")],
             "routing": [(fops, "adamw_routes" if hasattr(
                 fops, "adamw_routes") else "use_adamw")],
             "op": [(fops, "adamw_group" if multi else "adamw_leaf")],
             "wrapper": [(ak, "fused_adamw_multi" if multi
                          else "fused_adamw")],
             "lookup": [(kc, "for_launch")],
             "sync": []}
    spent = dict.fromkeys(timed, 0.0)

    def clocked(part, fn):
        def run_timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[part] += time.perf_counter() - t0
        return run_timed

    def call():
        opt(state.params, grads, state.opt)
        t0 = time.perf_counter()
        sync()
        spent["sync"] += time.perf_counter() - t0

    for _ in range(3):
        call()
    real = [(mod, name, getattr(mod, name)) for part, fns in timed.items()
            for mod, name in fns]
    for part, fns in timed.items():
        for mod, name in fns:
            setattr(mod, name, clocked(part, getattr(mod, name)))
    per_call, totals = [], []
    kernels.reset_launch_counts()
    try:
        for _ in range(calls):
            for k in spent:
                spent[k] = 0.0
            t0 = time.perf_counter()
            call()
            totals.append(time.perf_counter() - t0)
            per_call.append(dict(spent))
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    launches = kernels.launch_counts()["fused_adamw"] / calls

    def med(f):
        return 1e3 * statistics.median(f(c) for c in per_call)

    total = 1e3 * statistics.median(totals)
    parts = {
        "tree walk of adamw_update": med(lambda c: c["walk"]),
        "bias corrections": med(lambda c: c["bias"]),
        "routing (adamw_routes)": med(lambda c: c["routing"]),
        "custom_op dispatch (the routed call less the wrapper)": med(
            lambda c: c["op"] - c["wrapper"]),
        "tune lookup (for_launch)": med(lambda c: c["lookup"]),
        "wrapper: checks, pointers, table, launch": med(
            lambda c: c["wrapper"] - c["lookup"]),
        "waiting for the card (synchronize)": med(lambda c: c["sync"]),
    }
    parts["the rest (lists, the plain leaves, the call)"] = total - sum(
        parts.values())
    print(f"DeepCAM opt call, {len(tree_flatten(state.params)[0])} "
          f"leaves, O1, static, in place: {total:.3f} ms host clock (median "
          f"of {calls} synchronized calls, parts timed in place), "
          f"{launches:g} fused_adamw launches a call:")
    for label, ms in parts.items():
        print(f"  {label:<56} {ms:8.3f} ms {100 * ms / total:5.1f}%")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the host side of one opt call")
    ap.add_argument("--profile-only", action="store_true",
                    help="only the profile (no build, no checks)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("adamw_check: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import describe_gpu
    print(describe_gpu()["smi"])
    if not args.profile_only:
        import chip_smoke
        from repro_torch.core.machine import datasheet_for
        from repro_torch.kernels import build
        path, secs = build.build("fused", verbose=True)
        print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s")
        dev = torch.device("cuda", 0)
        sheet = datasheet_for(torch.cuda.get_device_name(0))
        g = torch.Generator(device=dev).manual_seed(1)

        def randn(shape, dtype, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)

        try:
            row = chip_smoke.adamw_checks(dev, sheet, randn)
        except AssertionError as e:
            print(f"adamw_check: {e}", file=sys.stderr)
            return 1
        print(f"  {row['name']} {row['shape']}: kernel {row['ms']:.4f} ms "
              f"(eager {row['eager_ms']:.4f}) | plain {row['plain_ms']:.4f} "
              f"ms | library {row['library_ms']:.4f} ms | bound "
              f"{row['bound_ms']:.4f} ms | config {row['config']}")
        torch.cuda.empty_cache()
    if args.profile or args.profile_only:
        profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
