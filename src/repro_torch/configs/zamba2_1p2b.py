"""zamba2-1.2b [hybrid] — Mamba-2 backbone + shared attention
[arXiv:2411.15242].

38 Mamba-2 layers; ONE shared attention+MLP block runs after every
``hybrid_group`` layers (per-site input norms de-share it).
``hybrid_group=6`` is the reference's documented assumption (the paper
alternates two shared blocks; this is the single-shared-block variant).
Its ``act="gelu"`` is the ungated tanh-approximate gelu.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, act="gelu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_n_groups=1,
    hybrid_group=6,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B",
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, act="gelu",
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_n_groups=1,
    hybrid_group=2,
)
