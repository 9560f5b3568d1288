"""Grok-1 314B [hf:xai-org/grok-1]: MoE, 8 experts top-2, GQA kv=8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072, head_dim=128, n_experts=8, top_k=2, act="gelu",
)
