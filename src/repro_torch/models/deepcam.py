"""DeepCAM: the paper's case-study network (§III-B), in two lowerings (port
of ``repro.models.deepcam``).

DeepLabv3+-style semantic segmentation: a ResNet-50 encoder with a dilated
stage 4 and ASPP pyramid pooling, a decoder of five 3×3 convs with two
skip connections (the stage-1 output and the projected stage-2 output),
per-pixel 3-class logits (background / tropical cyclone / atmospheric
river) over (B, H, W, 16) climate images.

The two lowerings compute the same function and launch different kernel
mixes, the paper's TensorFlow-vs-PyTorch comparison (``impl``):

* ``reference`` — conv, bias add, then the batch norm as separate ops,
  each norm round-tripping through fp32 (a cast up and a cast down of the
  activation under O1/O2: the zero-AI launches of paper Table III);
* ``fused``     — conv+bias+norm fused by construction: every norm
  follows a conv, so it folds into that conv's kernel and bias
  (``w·a`` and ``(b - mean)·a + bias`` with ``a = scale/√(var + eps)``,
  computed on the parameters, :func:`_fold`), and the activation stays in
  the compute dtype: one conv and one add per conv+norm.  The reference's
  ``fused`` lowering writes the norm out in the compute dtype and leaves
  the fusion to XLA; eager PyTorch fuses nothing, so the port folds.
  The gradients still reach ``scale``, ``bias``, ``mean`` and ``var``
  through the fold.

Layout and numerics, so that parameters and results transfer unchanged:

* activations are NHWC and conv kernels HWIO, as in the reference.  A conv
  takes ``x.permute(0, 3, 1, 2)`` — a channels-last NCHW view of the
  contiguous NHWC tensor, which cuDNN reads without a copy — and permutes
  its channels-last result back, for free;
* ``"SAME"`` padding is the reference's: XLA pads a strided conv
  asymmetrically (total ``max((⌈n/s⌉ - 1)·s + d·(k - 1) + 1 - n, 0)``,
  the extra row and column at the high end), so :func:`_conv` pads with
  ``F.pad`` where low and high differ, and passes ``padding=`` otherwise;
* :func:`_resize` is ``F.interpolate(mode="bilinear",
  align_corners=False, antialias=False)``: it equals ``jax.image.resize(
  ..., "bilinear")`` when upsampling, in any factor, the only direction
  DeepCAM resizes (by 2 and by 4).  Downsampling would need the
  antialiased filter, which the reference applies and the plain kernel
  does not, so :func:`_resize` refuses it.  The plain kernel has a
  channels-last CUDA path in bf16 (no layout copy);
* under O0 the convs must run in fp32, not TF32: cuDNN's
  ``torch.backends.cudnn.allow_tf32`` is True by default and the backward
  convs read it when they run, so the flag is a process setting, turned
  off where the port's entry points resolve a CUDA device
  (:func:`repro_torch.device.resolve_device`); code that drives
  :func:`deepcam_forward` on a card by other means sets it itself;
* BN ``mean`` and ``var`` are parameters (they receive gradients and
  AdamW updates, as in the reference), not buffers.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RunConfig
from repro_torch.models.params import P

Params = Any

IN_CHANNELS = 16
N_CLASSES = 3

# ResNet-50 stage plan: (blocks, out_channels, stride, dilation)
STAGES = ((3, 256, 1, 1), (4, 512, 2, 1), (6, 1024, 2, 1), (3, 2048, 1, 2))
ASPP_RATES = (1, 6, 12, 18)


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------

def _conv_spec(cin: int, cout: int, k: int = 3) -> Params:
    return {"w": P((k, k, cin, cout), (None, None, None, "ffn")),
            "b": P((cout,), ("ffn",), "zeros")}


def _bn_spec(c: int) -> Params:
    return {"scale": P((c,), ("ffn",), "ones"),
            "bias": P((c,), ("ffn",), "zeros"),
            "mean": P((c,), ("ffn",), "zeros"),
            "var": P((c,), ("ffn",), "ones")}


def _bottleneck_spec(cin: int, cout: int) -> Params:
    mid = cout // 4
    spec = {
        "c1": _conv_spec(cin, mid, 1), "n1": _bn_spec(mid),
        "c2": _conv_spec(mid, mid, 3), "n2": _bn_spec(mid),
        "c3": _conv_spec(mid, cout, 1), "n3": _bn_spec(cout),
    }
    if cin != cout:
        spec["proj"] = _conv_spec(cin, cout, 1)
        spec["projn"] = _bn_spec(cout)
    return spec


def deepcam_spec(width: int = 64) -> Params:
    """width=64 is real DeepCAM; smoke tests pass width=8."""
    w = width
    stages = []
    cin = w
    for blocks, cout_base, _s, _d in STAGES:
        cout = cout_base * w // 64
        stages.append([_bottleneck_spec(cin if i == 0 else cout, cout)
                       for i in range(blocks)])
        cin = cout
    c_enc = STAGES[-1][1] * w // 64
    c_aspp = 256 * w // 64
    c_skip = STAGES[0][1] * w // 64
    return {
        "stem": _conv_spec(IN_CHANNELS, w, 7), "stem_n": _bn_spec(w),
        "stages": stages,
        "aspp": {f"r{r}": _conv_spec(c_enc, c_aspp, 1 if r == 1 else 3)
                 for r in ASPP_RATES}
                | {"pool": _conv_spec(c_enc, c_aspp, 1),
                   "proj": _conv_spec(c_aspp * (len(ASPP_RATES) + 1),
                                      c_aspp, 1),
                   "proj_n": _bn_spec(c_aspp)},
        "dec": {
            "skip_proj": _conv_spec(c_skip, 48 * w // 64, 1),
            "mid_proj": _conv_spec(STAGES[1][1] * w // 64, 32 * w // 64, 1),
            "d1": _conv_spec(c_aspp + 48 * w // 64, c_aspp, 3),
            "d1n": _bn_spec(c_aspp),
            "d2": _conv_spec(c_aspp, c_aspp, 3), "d2n": _bn_spec(c_aspp),
            "d3": _conv_spec(c_aspp + 32 * w // 64, c_aspp, 3),
            "d3n": _bn_spec(c_aspp),
            "d4": _conv_spec(c_aspp, c_aspp // 2, 3),
            "d4n": _bn_spec(c_aspp // 2),
            "d5": _conv_spec(c_aspp // 2, c_aspp // 2, 3),
            "d5n": _bn_spec(c_aspp // 2),
            "head": _conv_spec(c_aspp // 2, N_CLASSES, 1),
        },
    }


# --------------------------------------------------------------------------
# Ops (both lowerings share the convs; ``fused`` folds the norms in)
# --------------------------------------------------------------------------

def same_padding(n: int, k: int, stride: int, dilation: int
                 ) -> tuple[int, int]:
    """(low, high) padding of XLA's ``"SAME"`` on a dimension of size
    ``n``: the output has ⌈n/stride⌉ positions, the odd row at the high
    end."""
    span = dilation * (k - 1) + 1
    total = max((-(-n // stride) - 1) * stride + span - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, p: Params, stride: int = 1, dilation: int = 1,
          cd: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC ``x`` · HWIO ``p["w"]`` + ``p["b"]`` with ``"SAME"`` padding, in
    ``cd``.  The bias is a separate add, as in the reference's program."""
    w = p["w"]
    k = w.shape[0]
    pads = [same_padding(n, k, stride, dilation) for n in x.shape[1:3]]
    xv = x.to(cd).permute(0, 3, 1, 2)          # channels-last NCHW view
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        (th, bh), (lw, rw) = pads
        xv = F.pad(xv, (lw, rw, th, bh))
        padding = (0, 0)
    y = F.conv2d(xv, w.to(cd).permute(3, 2, 0, 1), stride=stride,
                 padding=padding, dilation=dilation)
    return y.permute(0, 2, 3, 1) + p["b"].to(cd)


def _bn(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """Inference-style norm with learned statistics, the ``reference``
    lowering's: in fp32, cast back to ``x``'s dtype (the reference's
    ``_bn(upcast=True)``)."""
    dt = x.dtype
    x = x.float()
    inv = torch.rsqrt(p["var"].float() + eps)
    y = (x - p["mean"].float()) * inv * p["scale"].float() \
        + p["bias"].float()
    return y.to(dt)


def _fold(cp: Params, np_: Params, eps: float = 1e-5) -> Params:
    """The conv parameters ``cp`` with the norm ``np_`` that follows the
    conv folded in: ``conv(x, w·a) + (b - mean)·a + bias`` equals
    ``_bn(conv(x, w) + b)`` with ``a = scale·rsqrt(var + eps)``."""
    a = np_["scale"] * torch.rsqrt(np_["var"] + eps)
    return {"w": cp["w"] * a, "b": (cp["b"] - np_["mean"]) * a + np_["bias"]}


def _conv_bn(x: torch.Tensor, cp: Params, np_: Params, stride: int = 1,
             dilation: int = 1, cd: torch.dtype = torch.float32,
             fused: bool = False) -> torch.Tensor:
    """A conv and the norm after it, in either lowering."""
    if fused:
        return _conv(x, _fold(cp, np_), stride, dilation, cd)
    return _bn(_conv(x, cp, stride, dilation, cd), np_)


def _bottleneck(x: torch.Tensor, p: Params, stride: int, dilation: int,
                cd: torch.dtype, fused: bool) -> torch.Tensor:

    def cbr(h, cp, np_, s=1, d=1, act=True):
        h = _conv_bn(h, cp, np_, s, d, cd, fused)
        return torch.relu(h) if act else h

    h = cbr(cbr(cbr(x, p["c1"], p["n1"]), p["c2"], p["n2"], stride,
                dilation),
            p["c3"], p["n3"], act=False)
    if "proj" in p:
        x = _conv_bn(x, p["proj"], p["projn"], stride, 1, cd, fused)
    elif stride != 1:
        x = x[:, ::stride, ::stride]
    return torch.relu(x + h)


def _resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``hw`` (half-pixel centres), equal
    to ``jax.image.resize(x, ..., "bilinear")`` when no side shrinks."""
    if hw[0] < x.shape[1] or hw[1] < x.shape[2]:
        raise ValueError(
            f"_resize upsamples only: {tuple(x.shape[1:3])} -> {tuple(hw)} "
            "would need the reference's antialiased filter")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def resolve_impl(run: RunConfig, impl: str | None = None) -> str:
    """Which lowering a run selects: an explicit ``impl`` wins, then the
    ``RunConfig.impl`` knob, and ``fusion="auto"`` upgrades the default
    reference lowering to the fused one, as in the reference."""
    chosen = impl if impl is not None else run.impl
    if chosen == "reference" and run.fusion == "auto" and impl is None:
        return "fused"
    return chosen


def conv_plan(width: int, hw: tuple[int, int]
              ) -> list[tuple[str, int, int, int, int, int, int]]:
    """(name, H_out, W_out, k, c_in, c_out, stride) of every conv that
    :func:`deepcam_forward` runs on (·, *hw, 16) images, in order: the
    analytic conv FLOPs are Σ 2·B·H_out·W_out·k²·c_in·c_out."""
    spec = deepcam_spec(width)

    def out(n, s):
        return -(-n // s)

    plan = []

    def add(name, cp, hw_in, s=1):
        k, _, cin, cout = cp["w"].shape
        h, w = out(hw_in[0], s), out(hw_in[1], s)
        plan.append((name, h, w, k, cin, cout, s))
        return h, w

    cur = add("stem", spec["stem"], hw, 2)
    sizes = []
    for si, (stage, (_b, _c, stride, _d)) in enumerate(
            zip(spec["stages"], STAGES)):
        for bi, bp in enumerate(stage):
            s = stride if bi == 0 else 1
            tag = f"stages/{si}/{bi}"
            mid = add(f"{tag}/c1", bp["c1"], cur)
            mid = add(f"{tag}/c2", bp["c2"], mid, s)
            add(f"{tag}/c3", bp["c3"], mid)
            if "proj" in bp:
                add(f"{tag}/proj", bp["proj"], cur, s)
            cur = mid
        sizes.append(cur)
    for r in ASPP_RATES:
        add(f"aspp/r{r}", spec["aspp"][f"r{r}"], cur)
    add("aspp/pool", spec["aspp"]["pool"], (1, 1))
    add("aspp/proj", spec["aspp"]["proj"], cur)
    dp = spec["dec"]
    skip, mid = sizes[0], sizes[1]
    add("dec/skip_proj", dp["skip_proj"], skip)
    add("dec/d1", dp["d1"], skip)
    add("dec/d2", dp["d2"], skip)
    add("dec/mid_proj", dp["mid_proj"], mid)
    add("dec/d3", dp["d3"], skip)
    for name in ("d4", "d5", "head"):
        add(f"dec/{name}", dp[name], hw)
    return plan


def conv_flops(width: int, hw: tuple[int, int], batch: int) -> int:
    """Σ 2·B·H_out·W_out·k²·c_in·c_out over :func:`conv_plan`."""
    return sum(2 * batch * h * w * k * k * cin * cout
               for _, h, w, k, cin, cout, _ in conv_plan(width, hw))


def deepcam_forward(params: Params, images: torch.Tensor, run: RunConfig,
                    impl: str = "reference") -> torch.Tensor:
    """images (B, H, W, 16) → logits (B, H, W, 3) in fp32."""
    fused = impl == "fused"
    cd = run.compute_dtype
    x = images.to(cd)
    H, W = x.shape[1], x.shape[2]

    def cbr(h, cp, np_, s=1):
        return torch.relu(_conv_bn(h, cp, np_, s, 1, cd, fused))

    x = cbr(x, params["stem"], params["stem_n"], 2)
    skip = mid = None
    for si, (stage_p, (_b, _c, stride, dil)) in enumerate(
            zip(params["stages"], STAGES)):
        for bi, bp in enumerate(stage_p):
            x = _bottleneck(x, bp, stride if bi == 0 else 1, dil, cd, fused)
        if si == 0:
            skip = x
        if si == 1:
            mid = x

    # ASPP
    ap = params["aspp"]
    branches = [torch.relu(_conv(x, ap[f"r{r}"], 1, 1 if r == 1 else r, cd))
                for r in ASPP_RATES]
    pooled = torch.mean(x, dim=(1, 2), keepdim=True)
    pooled = torch.relu(_conv(pooled, ap["pool"], cd=cd))
    branches.append(pooled.expand(x.shape[0], x.shape[1], x.shape[2],
                                  pooled.shape[-1]))
    x = torch.cat(branches, dim=-1)
    x = cbr(x, ap["proj"], ap["proj_n"])

    # decoder: upsample to the skip resolution, two skip connections
    dp = params["dec"]
    x = _resize(x, (skip.shape[1], skip.shape[2]))
    sk = _conv(skip, dp["skip_proj"], cd=cd)
    x = torch.cat([x, sk], dim=-1)
    x = cbr(cbr(x, dp["d1"], dp["d1n"]), dp["d2"], dp["d2n"])
    mk = _resize(_conv(mid, dp["mid_proj"], cd=cd), (x.shape[1], x.shape[2]))
    x = torch.cat([x, mk], dim=-1)
    x = cbr(x, dp["d3"], dp["d3n"])
    x = _resize(x, (H, W))
    x = cbr(cbr(x, dp["d4"], dp["d4n"]), dp["d5"], dp["d5n"])
    return _conv(x, dp["head"], cd=cd).float()


def deepcam_loss(params: Params, images: torch.Tensor, labels: torch.Tensor,
                 run: RunConfig, impl: str = "reference") -> torch.Tensor:
    """Per-pixel cross-entropy: ``log_softmax`` in fp32 against a one-hot
    of the int32 labels (built by comparison with an ``arange``)."""
    logits = deepcam_forward(params, images, run, impl)
    logp = torch.log_softmax(logits.float(), dim=-1)
    classes = torch.arange(N_CLASSES, device=labels.device)
    onehot = (labels[..., None] == classes).float()
    return -torch.mean(torch.sum(onehot * logp, dim=-1))
