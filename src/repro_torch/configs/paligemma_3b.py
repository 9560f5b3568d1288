"""PaLI-Gemma 3B [arXiv:2407.07726]: SigLIP frontend (stubbed patch
embeddings) + gemma-style decoder. MQA (kv=1), prefix-LM attention over the
image tokens."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=257216, head_dim=256, act="gelu", n_patches=256,
)
