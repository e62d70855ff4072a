"""Chunked SSD (Mamba-2) scan on Hopper (port of
``repro.kernels.ssd_scan.kernel``).

The reference runs a (B, H, chunks) grid whose chunk axis is sequential,
with the (P, N) state in VMEM scratch across chunk steps.  Hopper blocks
run in no order, so the kernel (``csrc/ssd.cu``) splits the scan into
passes that each run in parallel: C·Bᵀ once per (batch, chunk), shared by
the heads; each chunk's own state increment; a short elementwise pass
over the chunks that turns increments into entering states; and every
chunk's output at once.  Every product runs on the tensor cores in
3xTF32 (each operand split into two TF32 halves), which keeps fp32
accuracy.  One call of :func:`ssd_scan` or :func:`ssd_scan_model` makes
three CUDA launches (two with a single chunk: there is no pass) and
counts as one launch in :data:`LAUNCHES`.  The plain version of the decomposition is
:func:`~.ref.ssd_split`.

* :func:`ssd_scan` — the reference's entry point on the kernel layout
  xdt (B, H, S, P), a (B, H, S), B/C (B, S, N): the plain version
  :func:`~.ref.ssd_ref` for CPU tensors, the kernel for CUDA tensors;
* :func:`ssd_scan_model` — the kernel on the model layout xh (B, S, H, P),
  a (B, S, H), B/C (B, S, N), with no transposes around it; CUDA tensors
  only (its plain version is ``models.ssm.ssd_chunked``, which the
  model-facing op runs on the CPU).

The kernel takes fp32 operands, ``S % chunk == 0``, chunks up to 256 and
N a multiple of 4 up to 128.  Its tiles are compile-time constants: the
config states them and the library is held against them when it loads.
The wrapper allocates the passes' scratch (:func:`scratch_floats`).
``hbm_bytes`` and ``flops`` are the reference's roofline model of the
kernel, mirrored as written; ``needed_flops`` counts only the work the
function needs, for its bound, and ``executed_flops`` the work the
kernel's tiles execute.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import config as kc
from repro_torch.kernels.ssd_scan.ref import ssd_ref

#: calls that launched the CUDA kernels, one a scan (the plain CPU path
#: does not count)
LAUNCHES = 0

#: the C interface's layout codes
_KERNEL_LAYOUT, _MODEL_LAYOUT = 0, 1
#: config keys of the compiled constants, in ``ssd_tile``'s order
_TILE_KEYS = ("block_q", "block_p", "threads", "max_chunk", "max_state")

_LIB = None


def _library():
    """The ``ssd`` library; on its first load its compiled constants are
    held against the config's."""
    global _LIB
    if _LIB is None:
        lib = build.load("ssd")
        compiled = tuple(lib.ssd_tile(i) for i in range(len(_TILE_KEYS)))
        want = tuple(int(kc.default_config("ssd_scan").get(k))
                     for k in _TILE_KEYS)
        if compiled != want:
            raise RuntimeError(f"csrc/ssd.cu is compiled for {_TILE_KEYS} = "
                               f"{compiled}, kernels/config.py states {want}")
        _LIB = lib
    return _LIB


def _check(x, a, B_, C_, layout: int, chunk: int
           ) -> tuple[int, int, int, int, int]:
    """(B, S, H, P, N) of operands in ``layout``; raises on shapes that do
    not fit together or a chunk that does not divide S."""
    if x.ndim != 4 or B_.ndim != 3 or B_.shape != C_.shape:
        raise ValueError(f"ssd_scan shapes x {tuple(x.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C_.shape)}")
    if layout == _KERNEL_LAYOUT:
        b, h, s, p = x.shape
        a_shape = (b, h, s)
    else:
        b, s, h, p = x.shape
        a_shape = (b, s, h)
    if tuple(a.shape) != a_shape or tuple(B_.shape[:2]) != (b, s):
        raise ValueError(f"ssd_scan shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(B_.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan needs S % chunk == 0, got S {s}, "
                         f"chunk {chunk}")
    return b, s, h, p, int(B_.shape[-1])


def _launch(x, a, B_, C_, dims: tuple[int, int, int, int, int],
            chunk: int, layout: int) -> torch.Tensor:
    """Launch on operands that ``_check`` returned ``dims`` for."""
    global LAUNCHES
    b, s, h, p, n = dims
    cfg = kc.default_config("ssd_scan")
    if chunk > cfg.get("max_chunk") or n > cfg.get("max_state") or n % 4:
        raise ValueError(f"the ssd_scan kernel takes chunks up to "
                         f"{cfg.get('max_chunk')} and N a multiple of 4 up "
                         f"to {cfg.get('max_state')}, got chunk {chunk}, "
                         f"N {n}")
    for t in (x, a, B_, C_):
        build.dtype_code(t, ("float32",))
    build.require_cuda(x, a, B_, C_, align=4)
    build.require_cuda(B_, C_, align=16)    # float4 loads of B and C rows
    lib = _library()
    y = torch.empty_like(x)
    cb_n, st_n, tot_n = scratch_floats(b, s, h, p, n, chunk)
    scratch = torch.empty(cb_n + st_n + tot_n, dtype=torch.float32,
                          device=x.device)
    cb, states, totals = scratch.split((cb_n, st_n, tot_n))
    err = lib.ssd_scan_fwd(x.data_ptr(), a.data_ptr(), B_.data_ptr(),
                           C_.data_ptr(), y.data_ptr(), cb.data_ptr(),
                           states.data_ptr(), totals.data_ptr(), b, s, h, p,
                           n, chunk, layout, build.stream_of(x))
    build.check(lib, err, "ssd_scan")
    LAUNCHES += 1
    return y


def ssd_scan(xdt: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, config: kc.KernelConfig | None = None,
             chunk: int | None = None) -> torch.Tensor:
    """xdt (B, H, S, P), a (B, H, S), B_/C_ (B, S, N) → y (B, H, S, P).

    ``chunk`` resolves explicit kwarg → ``config`` → the 128 default, and
    is clamped to S, as the reference's.  The other fields of ``config``
    are compiled into the kernel, so a config that asks for other values
    of them raises, on every device."""
    cfg = kc.resolve("ssd_scan", config, chunk=chunk)
    compiled = kc.default_config("ssd_scan")
    wrong = {k: cfg.get(k) for k in _TILE_KEYS
             if cfg.get(k) != compiled.get(k)}
    if wrong:
        raise ValueError(f"ssd_scan is compiled for "
                         f"{ {k: compiled.get(k) for k in wrong} }, config "
                         f"asks for {wrong}")
    q = int(cfg.get("chunk"))
    if xdt.ndim == 4:
        q = min(q, int(xdt.shape[2]))
    dims = _check(xdt, a, B_, C_, _KERNEL_LAYOUT, q)
    if all(t.device.type == "cpu" for t in (xdt, a, B_, C_)):
        return ssd_ref(xdt, a, B_, C_, chunk=q)
    return _launch(xdt, a, B_, C_, dims, q, _KERNEL_LAYOUT)


def ssd_scan_model(xh: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
                   C_: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The kernel on the model layout: xh (B, S, H, P), a (B, S, H),
    B_/C_ (B, S, N) → y (B, S, H, P); CUDA tensors only."""
    dims = _check(xh, a, B_, C_, _MODEL_LAYOUT, chunk)
    return _launch(xh, a, B_, C_, dims, chunk, _MODEL_LAYOUT)


def scratch_floats(b: int, s: int, h: int, p: int, n: int,
                   chunk: int) -> tuple[int, int, int]:
    """Floats of the kernel's three scratch arrays: C·Bᵀ of each chunk
    (B, chunks, Qp, Qp) with Qp the chunk rounded up to ``block_q``, the
    states (B, H, chunks, P, N) and the chunk totals (B, H, chunks).  The
    first two are multiples of 4 floats, so each array starts 16-byte
    aligned."""
    bq = int(kc.default_config("ssd_scan").get("block_q"))
    nc, qp = s // chunk, -(-chunk // bq) * bq
    return b * nc * qp * qp, b * h * nc * p * n, b * h * nc


def hbm_bytes(b: int, h: int, s: int, p: int, n: int,
              itemsize: int = 4) -> float:
    """Analytic traffic: x + y (B,H,S,P) + a + B/C once."""
    return float(b) * (2 * h * s * p + h * s + 2 * s * n) * itemsize


def flops(b: int, h: int, s: int, p: int, n: int, chunk: int) -> float:
    """Per-chunk: CBᵀ (2Q²N) + My (2Q²P) + state (2QPN + QP) + inter (2QPN)."""
    nc = s // chunk
    per_chunk = (2 * chunk * chunk * n + 2 * chunk * chunk * p
                 + 4 * chunk * p * n)
    return float(b * h * nc) * per_chunk


def needed_flops(b: int, h: int, s: int, p: int, n: int, chunk: int) -> float:
    """The least work the function needs, the operations term of its
    roofline bound (``flops`` is the reference's coarser model, which the
    op walk keeps):

    * C·Bᵀ over the causal pairs j ≤ i only, Q(Q+1)/2 of them, once per
      (batch, chunk): with one group, B and C are shared by every head;
    * per (batch, head, chunk) the decay product and M·x over the causal
      pairs, 1 + 2P operations a pair;
    * C·stateᵀ (2QPN) in every chunk after the first, whose entering state
      is zero, and the state update xᵀ·B (2QPN) in every chunk before the
      last, whose state only decoding reads.

    The exps and the O(Q·(P + N)) scalings per chunk are left out."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    shared = b * nc * 2 * pairs * n
    per_head = nc * pairs * (1 + 2 * p) + 2 * (nc - 1) * 2 * chunk * p * n
    return float(shared + b * h * per_head)


def executed_flops(b: int, h: int, s: int, p: int, n: int,
                   chunk: int) -> float:
    """The multiply-adds (2 FLOPs each) the kernel's tiles execute, padding
    included, each counted once (the tensor cores run each three times,
    for the hi/lo split):

    * C·Bᵀ: every causal pair of 64-row tiles of every (batch, chunk),
      over N rounded up to 8;
    * the increments (transposed): per (batch, head, chunk but the last,
      64 columns of P) 32 rows of N per warp that holds any, × P's
      columns in 8-column tiles × the chunk's rows rounded up to 8;
    * the outputs: per (batch, head, chunk, 64 columns of P) each query
      tile's rows that exist, in 16-row warps, × 64 keys of each earlier
      tile and, on the diagonal, the keys up to the warp's last row, ×
      P's columns in 8-column tiles; then in every chunk after the first
      × N rounded up to 8 for C·stateᵀ.

    The exps, the decay and the scalings are left out."""
    cfg = kc.default_config("ssd_scan")
    bq, bp = int(cfg.get("block_q")), int(cfg.get("block_p"))
    nc = s // chunk
    n8, nq = -(-n // 8) * 8, -(-chunk // bq)
    slices = [min(bp, p - p0) for p0 in range(0, p, bp)]
    pairs = nq * (nq + 1) // 2
    cb = b * nc * pairs * bq * bq * n8
    inc = sum(b * h * (nc - 1) * 32 * -(-n // 32) * -(-w // 8) * 8
              * -(-chunk // 8) * 8 for w in slices)
    out = 0
    for w in slices:
        cols = -(-w // 8) * 8
        for it in range(nq):
            for r0 in range(it * bq, min(chunk, (it + 1) * bq), 16):
                keys = it * bq + min(bq, -(-(r0 - it * bq + 16) // 8) * 8,
                                     -(-(chunk - it * bq) // 8) * 8)
                out += b * h * nc * 16 * keys * cols
                out += b * h * (nc - 1) * 16 * n8 * cols
    return 2.0 * (cb + inc + out)
