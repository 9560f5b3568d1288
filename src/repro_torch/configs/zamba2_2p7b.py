"""Zamba2 2.7B [arXiv:2411.15242]: Mamba2 backbone + one weight-shared
full-attention(+MLP) block invoked every 6 layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, head_dim=80, ssm_state=64, ssm_expand=2,
    ssm_head_dim=64, ssm_groups=1, ssm_conv=4, attn_every=6,
)
