"""The one generator of training traffic: a pool of token batches made
from the run's seed, on the device, by the parameters of a mix file
(``traffic/<name>.json``).

A mix of kind ``train`` states ``batch`` and ``seq_len`` (the rows and
tokens of one step), ``pool`` (how many distinct batches are made and
cycled) and ``tokens``: the marginal the ids are drawn from.  ``zipf``
with ``exponent`` s gives id r − 1 the weight 1 / r^s over the
configuration's vocabulary (the program's ``TokenStream`` marginal has
s = 1).  Each row is a sequence of ``seq_len + 1`` ids: tokens are the
first ``seq_len``, targets the last.  Every seed gets the same sizes;
the seed only changes which ids are drawn.
"""

from __future__ import annotations

import hashlib

import torch

KINDS = ("train",)
MARGINALS = ("zipf",)


def _seed(seed: int) -> int:
    h = hashlib.sha256(f"perfbench-traffic:{seed}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def check(mix: dict) -> None:
    """Raise for a mix this generator cannot make."""
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {mix.get('kind')!r}; known: {KINDS}")
    if mix["tokens"]["marginal"] not in MARGINALS:
        raise ValueError(f"token marginal {mix['tokens']['marginal']!r}; "
                         f"known: {MARGINALS}")
    for key in ("batch", "seq_len", "pool"):
        if int(mix[key]) < 1:
            raise ValueError(f"traffic {key} must be >= 1")


def pool(mix: dict, vocab: int, seed: int, device: torch.device | str
         ) -> list[dict[str, torch.Tensor]]:
    """``mix["pool"]`` batches of int32 ``tokens`` and ``targets``
    (batch, seq_len), drawn by inverse CDF from one generator."""
    check(mix)
    s = float(mix["tokens"]["exponent"])
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-s), 0)
    cdf /= cdf[-1].clone()
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed))
    n, b, t = int(mix["pool"]), int(mix["batch"]), int(mix["seq_len"])
    u = torch.rand((n, b, t + 1), generator=gen, dtype=torch.float64,
                   device=device)
    ids = torch.searchsorted(cdf, u).clamp_(max=vocab - 1).to(torch.int32)
    return [{"tokens": ids[i, :, :-1].contiguous(),
             "targets": ids[i, :, 1:].contiguous()} for i in range(n)]
