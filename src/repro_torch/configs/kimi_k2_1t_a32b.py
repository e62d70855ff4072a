"""kimi-k2-1t-a32b [moe] — 384 routed experts top-8 and one shared expert
[arXiv:2501.kimi2; unverified].

The reference's paper-table numbers: 61 layers, d_model 7168, 64 query
heads on 8 KV heads, head_dim 112 (7168 / 64), per-expert FFN width
2048, shared-expert width 2048 (``moe_shared_ff``).  Its fp32 weights
(about 4 TB) exceed one 80 GB card many times over: the port runs it at
the smoke size, and at full size only as the op walk on meta tensors.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163_840, act="swiglu", tie_embeddings=False,
    n_experts=384, experts_per_token=8, moe_shared_ff=2048,
    source="arXiv:2501.kimi2 (unverified paper-table)",
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=512, act="swiglu", tie_embeddings=False,
    n_experts=8, experts_per_token=2, moe_shared_ff=32,
)
