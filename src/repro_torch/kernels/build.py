"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into a shared library
with a plain C interface, which :func:`load` opens with ``ctypes``.  The
build happens at first use, from the sources in this package only, into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  The library's file name carries a hash of its source
and the headers it includes, so an edited kernel is rebuilt and a stale
one is never loaded.

Nothing here runs at import time: the CPU tests import this module on a
host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# no --use_fast_math: it would let the compiler contract and fold the
# FMA chain of fma_chain
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: the library each tuned kernel is compiled into (``csrc/<name>.cu``)
LIBRARY_OF = {"triad": "ert", "fma_chain": "ert", "ert_gemm": "ert",
              "flash_attention": "flash", "ssd_scan": "ssd",
              "fused_norm": "fused", "fused_swiglu": "fused",
              "fused_adamw": "fused"}

_P = ctypes.c_void_p
_I, _F, _LL = ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# every library exports ``<name>_error_string(int)``; :func:`load` binds it
# as the library's ``error_string``, which :func:`check` calls
_SIGNATURES = {
    "ert": {
        # a, b, o, n, scale, reps, dtype, blocks, threads, stream
        # a, b, o, n, scale, reps, dtype, blocks, threads, counter, stream
        "ert_triad": (_P, _P, _P, _LL, _F, _I, _I, _I, _I, _P, _P),
        # x, o, n, n_iters, ilp, a, b, dtype, blocks, threads, stream
        "ert_fma_chain": (_P, _P, _LL, _I, _I, _F, _F, _I, _I, _I, _P),
        # A, B, C, M, N, K, in_dtype, out_dtype, stream
        "ert_gemm": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
        "ert_gemm_tile": (_I,),
        "ert_error_string": (_I,),
    },
    "fused": {
        # x, h, scale, r, y, rows, d, eps, x_dtype, scale_dtype, out_dtype,
        # blocks, threads, stream
        "fused_rmsnorm": (_P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _I,
                          _I, _P),
        # x, scale, bias, y, rows, d, eps, x_dtype, scale_dtype, bias_dtype,
        # out_dtype, blocks, threads, stream
        "fused_layernorm": (_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _I, _I,
                            _I, _P),
        # g, u, y, n, act, in_dtype, out_dtype, blocks, threads, stream
        "fused_swiglu": (_P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
        # segment rows, n_segs, bc, lr, b1, b2, 1-b1, 1-b2, eps,
        # weight_decay, g/m/v/p dtypes, blocks (most), threads, stream
        "fused_adamw_multi": (_P, _I, _P, _F, _F, _F, _F, _F, _F, _F, _I,
                              _I, _I, _I, _I, _I, _P),
        "fused_error_string": (_I,),
    },
    "flash": {
        # q, k, v, o, lse (or None), B, Sq, Sk, H, KV, hd, causal, scale,
        # dtype, stream
        "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _F, _I, _P),
        # B, Sq, Sk, H, KV, hd
        "flash_bwd_scratch": (_I, _I, _I, _I, _I, _I),
        # q, k, v, o, lse, dout, dq, dk, dv, scratch, B, Sq, Sk, H, KV, hd,
        # causal, scale, dtype, stream
        "flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _F, _I, _P),
        "flash_tile": (_I,),
        # hd, dtype
        "flash_route": (_I, _I),
        "flash_error_string": (_I,),
    },
    "ssd": {
        # x, a, B, C, y, cb, states, totals (the scratch), B, S, H, P, N,
        # chunk, layout, stream
        "ssd_scan_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P),
        "ssd_tile": (_I,),
        "ssd_error_string": (_I,),
    },
}
_RESTYPES = {"flash_bwd_scratch": ctypes.c_longlong,
             "ert_error_string": ctypes.c_char_p,
             "fused_error_string": ctypes.c_char_p,
             "flash_error_string": ctypes.c_char_p,
             "ssd_error_string": ctypes.c_char_p}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` that ``torch.utils.cpp_extension`` finds."""
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (CUDA_HOME is unset and nvcc is "
                           "not on PATH): the CUDA kernels cannot be built")
    return path


def nvcc_flags() -> tuple[str, ...]:
    """:data:`NVCC_FLAGS`, then the space-separated flags of the
    ``REPRO_NVCC_FLAGS`` environment variable (a bring-up build's
    ``-DERT_GEMM_WATCHDOG``, ``tools/ert_gemm_check.py --watchdog``)."""
    return (*NVCC_FLAGS, *os.environ.get("REPRO_NVCC_FLAGS", "").split())


#: name -> digest of its source and flags, taken once a process
_DIGESTS: dict[str, str] = {}


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes with
    ``#include "..."``, directly or through another such header."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def digest(name: str) -> str:
    """16 hex digits of the hash of :func:`sources` of ``name`` and the
    flags it is built with: the library's identity (its file name; the
    stamp of a tune record of its kernels)."""
    if name not in _DIGESTS:
        h = hashlib.sha256()
        for path in sources(name):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
        h.update(" ".join(nvcc_flags()).encode())
        _DIGESTS[name] = h.hexdigest()[:16]
    return _DIGESTS[name]


def kernel_digest(kernel: str) -> str:
    """:func:`digest` of the library that compiles ``kernel``; ``""`` for
    a kernel no library compiles."""
    return digest(LIBRARY_OF[kernel]) if kernel in LIBRARY_OF else ""


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{digest(name)}.so"


#: per library, a pattern (a regular expression) of the entry functions
#: whose own registers and spills the build report prints beside the
#: summary
DETAIL = {"ert": "gemm_wgmma", "flash": "flash_fwd_wgmma|flash_bwd_d", "ssd": "ssd_"}


def ptxas_summary(report: str, detail: str | None = None) -> str:
    """One line from ``-Xptxas -v`` output: entry functions, the range of
    registers per thread, the most shared memory, and any spills; then the
    registers and spills of each entry function whose mangled name holds
    ``detail``, and every ptxas warning (a serialized ``wgmma``, an ignored
    ``setmaxnreg``)."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    smem = [int(b) for b in re.findall(r"(\d+) bytes smem", report)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                            report))
    if not regs:
        return "no ptxas report"
    line = (f"{len(regs)} entry functions, {min(regs)}-{max(regs)} "
            f"registers/thread, up to {max(smem or [0])} B static smem, "
            f"{spills} B spilled")
    if detail:
        for fn, body in re.findall(r"Compiling entry function '(\S+)'"
                                   r"(.*?)(?=Compiling entry function|$)",
                                   report, re.S):
            used = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            if re.search(detail, fn) and used:
                line += (f"\n  {fn}: {used.group(1)} registers/thread, "
                         f"{spill.group(1) if spill else 0} B spilled")
    for w in sorted(set(re.findall(r"ptxas[^\n]*warning[^\n]*", report))):
        line += f"\n  {w.strip()}"
    return line


def build(name: str, verbose: bool = False) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns
    (library path, seconds spent compiling — 0.0 when it was already
    built).  ``verbose`` adds ``-Xptxas -v`` and prints the summary of
    the compiler's register, shared-memory and spill report
    (:func:`ptxas_summary`)."""
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *nvcc_flags(), *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                           f"{proc.stderr[-8000:]}")
    if verbose:
        print(f"{name}.cu: {ptxas_summary(proc.stderr, DETAIL.get(name))}")
    os.replace(tmp, lib)      # atomic: a concurrent build sees all or none
    return lib, seconds


def load(name: str = "ert") -> ctypes.CDLL:
    """The kernel library ``name``, built on first use, with every entry
    point's ``argtypes`` / ``restype`` declared and its
    ``<name>_error_string`` bound as ``error_string``."""
    if name in _LOADED:
        return _LOADED[name]
    path, _ = build(name)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = _RESTYPES.get(fn, ctypes.c_int)
    lib.error_string = getattr(lib, f"{name}_error_string")
    _LOADED[name] = lib
    return lib


# --------------------------------------------------------------------------
# Launch helpers shared by the wrappers
# --------------------------------------------------------------------------

_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def dtype_code(t, allowed: tuple[str, ...] = tuple(_DTYPE_CODES)) -> int:
    """The C interface's code for ``t``'s dtype (``t`` a tensor or a
    dtype); raises for others."""
    dtype = getattr(t, "dtype", t)
    name = str(dtype).removeprefix("torch.")
    if name not in allowed:
        raise TypeError(f"dtype {dtype} not supported here; "
                        f"supported: {allowed}")
    return _DTYPE_CODES[name]


def require_cuda(*tensors, align: int = 16) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    whose data pointer is ``align``-byte aligned.  The ERT kernels load
    16-byte vectors with no scalar fallback and need 16; the fused
    kernels check alignment themselves and take any (``align=1``), so a
    per-layer view into a stacked parameter is never copied to align."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
        if t.data_ptr() % align:
            raise ValueError(f"expected {align}-byte aligned tensors")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(t) -> int:
    import torch
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
