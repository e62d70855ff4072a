"""Model-facing SSD scan (port of ``repro.kernels.ssd_scan.ops``).

``ssm_apply`` (``repro_torch.models.ssm``) calls
:func:`ssd_scan_model_layout` at ``ssd_impl="kernel"`` with fp32 xh
(B, S, H, P), a_log_dt (B, S, H) and B/C (B, S, N).  It is one op,
``repro_torch::ssd_scan``:

* its implementation launches the kernel on the model layout for CUDA
  tensors (the reference's wrapper transposes to (B, H, S, P) and back)
  and runs the plain ``ssd_chunked`` for CPU tensors;
* ``register_fake`` gives its output shape, so the op walk on meta
  tensors sees one op and allocates nothing;
* its backward recomputes the plain ``ssd_chunked`` on the saved inputs
  and differentiates it — what the reference's ``custom_vjp`` does (it
  has no backward kernel either).

The model passes its chunk explicitly (``min(cfg.ssm_chunk, S)``); the
reference's tune-store lookup for ``chunk=None`` is not ported, so
``None`` means the config default, 128.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import config as kc
from repro_torch.kernels.fused.ops import _vjp
from repro_torch.kernels.ssd_scan import kernel as sk


def _plain(xh, a, B_, C_, chunk: int) -> torch.Tensor:
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(xh, a, B_, C_, chunk)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_op(xh: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
            C_: torch.Tensor, chunk: int) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (xh, a, B_, C_)):
        return _plain(xh, a, B_, C_, chunk)
    return sk.ssd_scan_model(xh, a, B_, C_, chunk=chunk)


@_ssd_op.register_fake
def _(xh, a, B_, C_, chunk):
    return torch.empty_like(xh)


def _ssd_setup(ctx, inputs, output):
    *saved, ctx.chunk = inputs
    ctx.save_for_backward(*saved)


def _ssd_bwd(ctx, g):
    grads = _vjp(lambda *t: _plain(*t, ctx.chunk), ctx.saved_tensors, (g,))
    return (*grads, None)


_ssd_op.register_autograd(_ssd_bwd, setup_context=_ssd_setup)


def ssd_scan_model_layout(xh: torch.Tensor, a_log_dt: torch.Tensor,
                          B_: torch.Tensor, C_: torch.Tensor,
                          chunk: int | None = None) -> torch.Tensor:
    """xh (B, S, H, P), a_log_dt (B, S, H), B_/C_ (B, S, N) →
    (B, S, H, P); ``chunk`` clamped to S, ``None`` the default 128."""
    q = chunk if chunk is not None else int(
        kc.default_config("ssd_scan").get("chunk"))
    q = min(q, int(xh.shape[1]))
    if q < 1 or xh.shape[1] % q:
        raise ValueError(f"ssd_scan needs S % chunk == 0, got S "
                         f"{xh.shape[1]}, chunk {q}")
    return _ssd_op(xh.contiguous(), a_log_dt.contiguous(), B_.contiguous(),
                   C_.contiguous(), q)
