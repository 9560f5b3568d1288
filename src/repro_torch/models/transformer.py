"""Model assembly (counterpart of ``repro.models.transformer``), dense and
MoE families on one device:

    params = init(cfg, seed, device)               # a Transformer module
    logits = forward(params, cfg, batch)           # train / prefill logits
    cache  = init_cache(cfg, B, max_len)           # serving
    logits, cache = decode_step(params, cfg, cache, tokens)

Parameters map one-to-one onto the reference's tree: its ``layers.*``
leaves carry a leading layer axis, here ``layers[i].*`` is one module per
layer (``models.convert`` unstacks and restacks). Layers run as a Python
loop in place of the reference's ``scan``; ``remat`` checkpoints each block
(``dispatch.checkpoint``, whose recompute re-enters the forward's policy).

Every GEMM site here is a forward site name; differentiating ``forward``
dispatches the matching ``<site>@bwd.dA``/``<site>@bwd.dB`` sites through
the dispatch layer's autograd functions. Serving (``prefill``,
``decode_step``) runs under ``torch.inference_mode()`` and builds no graph.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import dispatch
from repro_torch.device import resolve_device

from . import layers as L
from . import moe as MOE
from .config import ModelConfig, check_family


class Block(nn.Module):
    """One decoder block: attn_norm, attn, mlp_norm, then moe (when the
    config has experts) or mlp."""

    def __init__(self, cfg: ModelConfig, gen=None, dtype=torch.float32, device=None):
        super().__init__()
        ones = lambda: L._param(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.attn_norm = ones()
        self.attn = L.init_attention(gen, cfg, dtype, device)
        self.mlp_norm = ones()
        if cfg.n_experts:
            self.moe = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                    dtype, device)
        elif cfg.d_ff:
            self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)


class Transformer(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) and one Block per layer.
    With ``gen=None`` the weights are left uninitialized (to be copied in)."""

    def __init__(self, cfg: ModelConfig, gen=None, dtype=torch.float32, device=None):
        super().__init__()
        check_family(cfg)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = L._normal((V, d), d ** -0.5, gen, dtype, device)
        self.final_norm = L._param(torch.ones(d, dtype=dtype, device=device))
        self.lm_head = L._normal((d, V), d ** -0.5, gen, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, gen, dtype, device)
                                    for _ in range(cfg.n_layers))


def init(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (CUDA unless the caller asks for another)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, gen, getattr(torch, cfg.param_dtype), dev)


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------
def _decoder_block(x, p: Block, cfg, *, positions, prefix_len=0, kv_cache=None):
    """Returns (x, new_kv_cache)."""
    h, new_cache = L.attention_block(
        L.rms_norm(x, p.attn_norm, cfg.norm_eps), p.attn, cfg, causal=True,
        prefix_len=prefix_len, positions=positions, kv_cache=kv_cache)
    x = x + h
    if cfg.n_experts:
        x = x + MOE.moe_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.moe, cfg)
    elif cfg.d_ff:
        x = x + L.mlp_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.mlp, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _embed(params: Transformer, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens]


def _logits(params: Transformer, cfg, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = L.dense(x.to(torch.float32), params.lm_head.to(torch.float32), "lm_head")
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.zeros(cfg.padded_vocab, dtype=torch.float32, device=x.device)
        mask[cfg.vocab_size:] = -torch.inf
        logits = logits + mask
    return logits


# ---------------------------------------------------------------------------
# Forward (prefill): full-sequence logits
# ---------------------------------------------------------------------------
def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            remat: str = "block", return_hidden: bool = False) -> torch.Tensor:
    """batch: {"tokens": (B, S)}. Returns logits (B, S, padded_vocab) f32, or
    the final-norm hidden states (B, S, d) when ``return_hidden`` (the
    chunked loss computes the head itself). ``remat`` "block" or "full"
    checkpoints every block while gradients are recorded (the recompute
    gives the same bits); "none" keeps every activation."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat {remat!r} (expected none, block or full)")
    x = _embed(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)

    def body(h, blk):
        return _decoder_block(h, blk, cfg, positions=positions)[0]

    use_remat = remat != "none" and torch.is_grad_enabled()
    for blk in params.layers:
        x = dispatch.checkpoint(body, x, blk) if use_remat else body(x, blk)
    if return_hidden:
        return L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode_step
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Float KV cache for incremental decoding: {"len": 0, "layers": {"k",
    "v": (n_layers, B, n_kv_heads, max_len, head_dim)}}. (The int8 cache
    comes with a later slice.)"""
    check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"len": 0,
            "layers": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}


@torch.inference_mode()
def decode_step(params: Transformer, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor):
    """One incremental decode step. tokens: (B, 1) int.
    Returns (logits (B, 1, V), new_cache); the cache tensors are updated in
    place and shared with the returned cache."""
    x = _embed(params, cfg, tokens)
    ln = cache["len"]
    pos = torch.full((x.shape[0], 1), ln, dtype=torch.int64, device=x.device)
    kv_layers = cache["layers"]
    for i, blk in enumerate(params.layers):
        kv = {"k": kv_layers["k"][i], "v": kv_layers["v"][i], "len": ln}
        x, _ = _decoder_block(x, blk, cfg, positions=pos, kv_cache=kv)
    return _logits(params, cfg, x), {"len": ln + 1, "layers": kv_layers}


@torch.inference_mode()
def prefill(params: Transformer, cfg: ModelConfig, batch: dict, cache: dict):
    """Fill the cache from a prompt by running decode_step over positions.
    Returns (last logits (B, V), cache)."""
    tokens = batch["tokens"]
    last = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, cache, tokens[:, t:t + 1])
        last = logits[:, 0]
    return last, cache
