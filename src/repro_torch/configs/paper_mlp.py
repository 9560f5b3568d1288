"""The paper's own workload family: a small dense transformer classifier used
for the Fig.-3 accuracy-vs-energy sweeps (the ResNet/ImageNet analogue at
laptop scale; see DESIGN.md §6)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-mlp", family="dense",
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024,
    vocab_size=512, head_dim=64,
)
