"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407].

Its bf16 weights alone (245 GB) exceed one 80 GB card: the port runs it at
the smoke size, and at full size only as the op walk on meta tensors."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768, act="swiglu", rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Large-Instruct-2407 (unverified)",
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=320, vocab_size=512, act="swiglu", tie_embeddings=False,
)
