"""seamless-m4t-large-v2 [audio] — encoder-decoder [arXiv:2308.11596].

The transformer backbone only, as in the reference: a 24-layer encoder
over precomputed speech-frame embeddings (the w2v-BERT frontend is a
stub) and a 24-layer decoder with cross-attention.  The encoder takes
``seq_len // FRAME_DOWNSAMPLE`` frames (the conformer's 8x downsampling
of 16 kHz filterbank frames).
"""

from repro_torch.configs.base import ModelConfig

#: encoder frames of an enc-dec cell: ``seq_len // FRAME_DOWNSAMPLE``
FRAME_DOWNSAMPLE = 8

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256_206, act="gelu", tie_embeddings=False,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=2, n_encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, act="gelu", tie_embeddings=False,
)
