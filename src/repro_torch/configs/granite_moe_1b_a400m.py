"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, act="swiglu",
    n_experts=32, experts_per_token=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, act="swiglu",
    n_experts=4, experts_per_token=2,
)
