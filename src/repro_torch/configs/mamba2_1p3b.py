"""Mamba2 1.3B [arXiv:2405.21060]: attention-free SSD. d_ff=0 (no MLP).
vocab 50280 padded to 50304 for TP sharding (logits masked)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, ssm_conv=4,
)
