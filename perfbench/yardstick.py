"""The frozen yardstick: published peaks and the operations and bytes each
measured kernel, and a whole train step, need.

A kernel's bound is the larger of its operations over the peak rate of
the precision it runs in and its bytes over the HBM bandwidth.  Each
input byte is counted read once and each output byte written once,
whatever the kernel reads again.  The counts follow the shapes of a
call, not the program's own roofline model.
"""

from __future__ import annotations

import math

#: NVIDIA's data sheet for the H100 SXM5 80 GB, dense rates without
#: sparsity, at its 700 W limit: FLOP/s by precision and HBM bytes/s
H100_SXM = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12}

#: the data sheet of each card kind, by ``torch.cuda.get_device_name()``
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks(kind: str) -> dict | None:
    """The peaks of the card ``kind``, or None for a card with no entry
    (a share of an unknown peak is not reported)."""
    return PEAKS.get(kind)


def bound_s(flops: float, nbytes: float, flop_rate: float,
            hbm: float) -> float:
    """The least time of a call: max(operations / rate, bytes / HBM)."""
    return max(flops / flop_rate, nbytes / hbm)


# --------------------------------------------------------------------------
# Flash attention (forward, causal)
# --------------------------------------------------------------------------

def flash_flops(b: int, h: int, s: int, hd: int) -> float:
    """QKᵀ and PV over the causal half of the score square:
    2·B·H·S²·hd (each product is 2·B·H·S²·hd unmasked)."""
    return 2.0 * b * h * s * s * hd


def flash_bytes(b: int, s: int, h: int, kv: int, hd: int,
                itemsize: int) -> float:
    """Q (B, S, H, hd) and K, V (B, S, KV, hd) read once at their own
    head counts, O (B, S, H, hd) written once."""
    return float(itemsize) * b * s * hd * (2 * h + 2 * kv)


# --------------------------------------------------------------------------
# SSD scan (Mamba-2), forward
# --------------------------------------------------------------------------

def ssd_needed_flops(b: int, h: int, s: int, p: int, n: int,
                     chunk: int) -> float:
    """The least work of the chunked scan with one group:

    * C·Bᵀ over the causal pairs j ≤ i, Q(Q+1)/2 of them, once per
      (batch, chunk), shared by the heads;
    * per (batch, head, chunk) the decay product and M·x over the causal
      pairs, 1 + 2P operations a pair;
    * C·stateᵀ (2QPN) in every chunk after the first and the state
      update xᵀ·B (2QPN) in every chunk before the last.

    The exps and the O(Q·(P + N)) scalings are left out."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    shared = b * nc * 2 * pairs * n
    per_head = nc * pairs * (1 + 2 * p) + 2 * (nc - 1) * 2 * chunk * p * n
    return float(shared + b * h * per_head)


def ssd_bytes(b: int, h: int, s: int, p: int, n: int,
              itemsize: int = 4) -> float:
    """x (B, S, H, P), the log-decay (B, S, H), B and C (B, S, N) read
    once; y (B, S, H, P) written once."""
    return float(itemsize) * b * s * (2 * h * p + h + 2 * n)


# --------------------------------------------------------------------------
# RMSNorm and AdamW (bound by their bytes)
# --------------------------------------------------------------------------

def rmsnorm_bytes(rows: int, d: int, itemsize: int, residual: bool,
                  scale_itemsize: int = 4) -> float:
    """x (and the residual h) read, y (and the sum r) written, each
    (rows, d) in the activation dtype; the scale read once."""
    streams = 4 if residual else 2
    return float(streams * rows * d * itemsize + d * scale_itemsize)


def adamw_bytes(n: int, itemsize: int = 4) -> float:
    """g, m, v and p read and p, m and v written, n elements each, plus
    the (2,) fp32 bias corrections."""
    return float(7 * n * itemsize + 8)


# --------------------------------------------------------------------------
# Model FLOPs of one train step
# --------------------------------------------------------------------------

def train_flops(tokens: int, weights_per_token: int,
                mixer_fwd_flops: float) -> float:
    """FLOPs of one train step (forward and backward), recompute not
    counted: 6 × tokens × the weights a token multiplies, and 3 × the
    forward FLOPs of the sequence mixers that no weight count holds
    (causal attention's scores, the SSD scan).  Each reference family
    (``reference/<family>.py``) gives its ``model_flops`` through this
    from its own counts, so a new family is a new file."""
    return 6.0 * tokens * weights_per_token + 3.0 * mixer_fwd_flops


def param_count(shapes) -> int:
    """Elements of every leaf, from (path, shape) pairs."""
    return sum(math.prod(shape) for _, shape in shapes)
