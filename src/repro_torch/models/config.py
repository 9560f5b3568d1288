"""Model configuration covering all architecture families (plain data,
counterpart of ``repro.models.config``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

# Families the port runs: every family of the reference's model zoo.
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg: "ModelConfig") -> None:
    """Raise for a family name that neither package builds."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(
            f"{cfg.name}: unknown family {cfg.family!r}; the port builds "
            f"{', '.join(PORTED_FAMILIES)}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free
    n_kv_heads: int
    d_ff: int                     # 0 => no MLP block (pure SSM)
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # transformer details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    act: str = "silu"                       # silu (GLU) | gelu (GLU)
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    # hybrid (zamba2-style shared attention block)
    attn_every: int = 0                     # 0 => not hybrid
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                        # fixed encoder frames
    # vlm
    n_patches: int = 0
    # numerics / sizes
    param_dtype: str = "float32"
    # attention chunking for long sequences
    attn_chunk: int = 1024

    def __post_init__(self):
        if self.n_heads:
            object.__setattr__(
                self, "head_dim", self.head_dim or self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:               # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 32 (logits for padded ids are
        masked to -inf)."""
        return -(-self.vocab_size // 32) * 32

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (the reference's)."""
        base = dict(
            name=self.name + "-reduced",
            family=self.family,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16 if self.n_heads else None,
            qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm,
            act=self.act,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_expand=self.ssm_expand,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_groups=self.ssm_groups,
            ssm_conv=self.ssm_conv,
            attn_every=1 if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16 if self.n_enc_layers else 0,
            n_patches=8 if self.n_patches else 0,
            attn_chunk=32,
        )
        if self.n_heads:
            base["n_kv_heads"] = min(self.n_kv_heads, base["n_heads"])
            if self.n_kv_heads == 1:
                base["n_kv_heads"] = 1
        base.update(over)
        return ModelConfig(**base)
