"""Modality frontend stubs (port of ``repro.models.multimodal``).

``phi-3-vision`` and ``seamless-m4t`` specify the transformer backbone;
the CLIP patch encoder and the speech frame encoder are stubs whose job
is to provide correctly shaped precomputed embeddings:

* VLM: ``prefix`` (B, n_prefix_embeds, d_model), prepended to the tokens;
* audio: ``frames`` (B, n_frames, d_model), the encoder's input
  (``models/api.py::batch_schema``).

:func:`prefix_spec` gives the shape as a meta tensor,
:func:`synthetic_prefix` concrete embeddings (``api.synthetic_batch``'s
draw of a VLM's ``prefix``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def prefix_spec(cfg: ModelConfig, batch: int,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The patch embeddings of ``batch`` sequences, on ``meta``."""
    return torch.empty((batch, cfg.n_prefix_embeds, cfg.d_model),
                       dtype=dtype, device="meta")


def synthetic_prefix(cfg: ModelConfig, batch: int,
                     generator: torch.Generator | None,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """Patch embeddings drawn from ``generator``: a float32 normal × 0.02,
    cast to ``dtype`` (the reference's draw, from a torch generator)."""
    x = torch.randn((batch, cfg.n_prefix_embeds, cfg.d_model),
                    generator=generator, dtype=torch.float32, device=device)
    return x.mul_(0.02).to(dtype)
