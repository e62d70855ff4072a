"""The port's device rule and a description of the card.

Entry points default to ``"cuda"``.  Without a CUDA device they raise and
name the device that was asked for; they run on the host only when the
caller passes ``device="cpu"``.  There is no silent fallback.

fp32 means fp32 on the card: resolving a CUDA device turns cuDNN's TF32
off (``torch.backends.cudnn.allow_tf32``, True by default), as PyTorch's
default already has it for matmuls, so an O0 conv computes what the
reference's fp32 conv does.  It is a process setting because a conv's
backward reads the flag when it runs, after the forward has returned.
"""

from __future__ import annotations

import shutil
import subprocess

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """``torch.device`` for ``device``, or raise if it is not usable here
    (a CUDA device also turns cuDNN's TF32 off, see the module doc)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for, but this torch "
                f"({torch.__version__}) finds no CUDA device; pass "
                "device='cpu' to run the plain PyTorch versions on the host")
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")


def device_label(dev: torch.device) -> str:
    """``"cpu"``, or ``"cuda:0 (<the card's name>)"``: the device a
    record's ``meta`` names."""
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def describe_gpu() -> dict[str, object]:
    """Name, compute capability and power limit of the first CUDA card;
    ``smi`` is ``name, power.limit`` exactly as ``nvidia-smi`` prints it."""
    if not torch.cuda.is_available():
        raise RuntimeError("describe_gpu needs a CUDA device; none found")
    if shutil.which("nvidia-smi") is None:
        raise RuntimeError("nvidia-smi is not on PATH")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi = out.stdout.splitlines()[0].strip()
    return {
        "name": torch.cuda.get_device_name(0),
        "capability": torch.cuda.get_device_capability(0),
        "power_limit": smi.split(",")[-1].strip(),
        "smi": smi,
    }
