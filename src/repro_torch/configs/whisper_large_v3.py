"""Whisper large-v3 [arXiv:2212.04356]: encoder-decoder; the conv audio
frontend is a stub (input_specs provides (B, 1500, d) frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, head_dim=64, act="gelu",
    n_enc_layers=32, enc_seq=1500,
)
