"""glm4-9b [dense] — RoPE, extreme GQA (kv=2) [hf:THUDM/glm-4-9b]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151_552, act="swiglu", tie_embeddings=False,
    source="hf:THUDM/glm-4-9b",
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=224, vocab_size=512, act="swiglu", tie_embeddings=False,
)
