"""Qwen3 0.6B [hf:Qwen/Qwen3]: dense GQA kv=8 with qk_norm, head_dim 128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab_size=151936, head_dim=128, qk_norm=True,
)
