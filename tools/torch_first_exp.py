"""Reproduce a wrong first parallel ``torch.exp`` on a CPU host.

On some hosts the first parallel ``torch.exp`` of a fresh process now and
then returns one intra-op thread's share of the elements about 1e-4
(relative) off, while every later call is right.  The wrong values are
the same in every process that shows them, so that thread runs another,
less accurate approximation rather than reading corrupt data.  This
script starts ``--procs`` fresh processes (``--jobs``
at a time); each computes one parallel ``exp`` of a fixed fp32 tensor,
optionally after a warm-up, and compares it with numpy's float64 ``exp``.
It prints one line per process that went wrong and a summary::

    python tools/torch_first_exp.py --procs 200 --warm none
    python tools/torch_first_exp.py --procs 200 --warm exp

``--warm none`` calls ``exp`` cold; ``exp`` and ``log`` first make one
8-element call of that function on the main thread only (what importing
``repro_torch`` does with ``exp``); ``add`` first runs one large parallel
add, which starts the intra-op threads without any ``exp``.  Setting
``ATEN_CPU_CAPABILITY`` (``avx2``, ``default``) reaches the children.
It needs only PyTorch and numpy.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys

#: relative error above which a float32 ``exp`` is counted wrong (a
#: correctly rounded one is within 6e-8)
REL_TOL = 1e-6


def child(warm: str) -> dict:
    """One process's first parallel ``exp``: the elements over REL_TOL,
    the largest relative error and the intra-op thread count."""
    import numpy as np
    import torch

    if warm == "exp":
        torch.ones(8).exp()
    elif warm == "log":
        torch.ones(8).log()
    elif warm == "add":
        torch.rand(1 << 22) + 1.0
    torch.manual_seed(0)
    x = -torch.rand(2, 4, 64, 64, 3) * 0.3
    y = x.exp().double()
    truth = torch.from_numpy(np.exp(x.double().numpy()))
    rel = (y - truth).abs() / truth
    bad = rel.reshape(-1) > REL_TOL
    idx = bad.nonzero().reshape(-1)
    return {"wrong": int(bad.sum()), "of": rel.numel(),
            "max_rel": float(rel.max()),
            "first": int(idx[0]) if len(idx) else None,
            "last": int(idx[-1]) if len(idx) else None,
            "threads": torch.get_num_threads(),
            "capability": torch.backends.cpu.get_cpu_capability()}


def _run_one(warm: str) -> dict:
    out = subprocess.run([sys.executable, __file__, "--child", warm],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=100)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--warm", choices=("none", "exp", "log", "add"),
                    default="none")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child)))
        return 0
    wrong = 0
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for res in pool.map(_run_one, [args.warm] * args.procs):
            if res["wrong"]:
                wrong += 1
                print(json.dumps(res), flush=True)
    print(f"{wrong} of {args.procs} fresh processes computed a wrong first "
          f"parallel exp (warm-up: {args.warm})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
