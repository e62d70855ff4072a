"""mamba2-1.3b [ssm] — SSD, attention-free [arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_n_groups=1,
    ssm_chunk=256, tie_embeddings=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-1.3b (unverified)",
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    n_layers=2, d_model=64, d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_n_groups=1,
    ssm_chunk=32,
)
