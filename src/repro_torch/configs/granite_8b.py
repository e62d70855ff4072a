"""granite-8b [dense] — llama-arch, code [arXiv:2405.04324; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152, act="swiglu",
    source="arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base",
)

SMOKE = ModelConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=224, vocab_size=512, act="swiglu",
)
