"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256_000, act="relu2",   # nemotron's squared relu
    source="arXiv:2407.14679; hf:nvidia/Minitron-4B-Base",
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=288, vocab_size=512, act="relu2",
)
