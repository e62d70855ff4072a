"""phi-3-vision-4.2b [vlm] — the phi3-mini backbone behind a stubbed
CLIP frontend [hf:microsoft/Phi-3-vision-128k-instruct].

The CLIP-L/14 image encoder is a stub, as in the reference: the batch
carries 576 precomputed patch embeddings (336 px / 14 px patches, one
crop), prepended to the token sequence (``models/multimodal.py``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, act="swiglu", rope_theta=10_000.0,
    n_prefix_embeds=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, act="swiglu", n_prefix_embeds=16,
)
