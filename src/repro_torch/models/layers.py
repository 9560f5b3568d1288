"""Transformer layer substrate (counterpart of ``repro.models.layers``,
single device). Every matmul routes through ``repro_torch.core.dispatch``
so numerics policies apply to the whole model.

Layouts are the reference's: weights (K, N) with ``dense(x, w) = gemm(x,
w)``; q/k/v (B, H, S, hd). Parameters live in ``nn.Module``s whose
attribute names are the reference's dict keys.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch


def _param(t: torch.Tensor) -> nn.Parameter:
    # Trainable: the dispatch sites carry gradients through their backward
    # GEMMs. Serving runs under torch.inference_mode() and builds no graph.
    return nn.Parameter(t, requires_grad=True)


def _normal(shape, scale, gen, dtype, device) -> nn.Parameter:
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    return _param(torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Dense projection through the numerics dispatch layer
# ---------------------------------------------------------------------------
def dense(x: torch.Tensor, w: torch.Tensor, site: str,
          bias: Optional[torch.Tensor] = None,
          plan: Optional[dispatch.GemmPlan] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) via the dispatch layer; returns x.dtype."""
    out = dispatch.gemm(x, w, site=site, plan=plan)
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, hd), positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].to(torch.float32) * freqs  # (B,1,S,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    xr = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return xr.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, chunked online softmax)
# ---------------------------------------------------------------------------
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              chunk: int = 1024, prefix_len: int = 0, q_offset: int = 0,
              site: str = "attn") -> torch.Tensor:
    """Chunked (flash-style) attention with online softmax.

    q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd). GQA via head grouping (no kv
    repeat). ``prefix_len``: bidirectional prefix. ``q_offset``: absolute
    position of q[0]. Returns (B, H, Sq, hd) in q.dtype."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    q = q.reshape(B, Hkv, G, Sq, hd)
    scale = hd ** -0.5
    dev = q.device

    nc = -(-Sk // chunk)
    pad = nc * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, Hkv, G, Sq), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=torch.float32, device=dev)
    for ci in range(nc):
        kci = k[:, :, ci * chunk:(ci + 1) * chunk]
        vci = v[:, :, ci * chunk:(ci + 1) * chunk]
        s = dispatch.grouped_qk(q, kci, site=site + "_qk").to(torch.float32) * scale
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        valid = k_pos < Sk
        if causal:
            ok = (k_pos[None, :] <= q_pos[:, None]) | (k_pos[None, :] < prefix_len)
        else:
            ok = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        ok = ok & valid[None, :]
        s = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(ok, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        pv = dispatch.grouped_av(p.to(v.dtype), vci, site=site + "_av")
        acc = acc * alpha[..., None] + pv.to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     cache_len: int, site: str = "attn") -> torch.Tensor:
    """Single-step attention against a (possibly longer-than-valid) KV
    cache. q: (B, H, 1, hd); k, v: (B, Hkv, Smax, hd); cache_len: valid
    prefix. (The int8 cache with scales, and the per-slot ``start`` of
    continuous batching, come with later slices.)"""
    B, H, Sq, hd = q.shape
    Hkv, Smax = k.shape[1], k.shape[2]
    qv = q.reshape(B, Hkv, H // Hkv, Sq, hd)
    s = dispatch.grouped_qk(qv, k, site=site + "_qk").to(torch.float32) * hd ** -0.5
    valid = torch.arange(Smax, device=q.device) < cache_len
    s = torch.where(valid, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = dispatch.grouped_av(p.to(v.dtype), v, site=site + "_av")
    return out.reshape(B, H, Sq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + norm options)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Parameters of one attention block: wq, wk, wv, wo (+ bq/bk/bv with
    qkv_bias, + q_norm/k_norm with qk_norm)."""

    def __init__(self, cfg, gen=None, dtype=torch.float32, device=None):
        super().__init__()
        d, H, Kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(gen=gen, dtype=dtype, device=device)
        self.wq = _normal((d, H * hd), d ** -0.5, **kw)
        self.wk = _normal((d, Kh * hd), d ** -0.5, **kw)
        self.wv = _normal((d, Kh * hd), d ** -0.5, **kw)
        self.wo = _normal((H * hd, d), (H * hd) ** -0.5, **kw)
        zeros = lambda n: _param(torch.zeros(n, dtype=dtype, device=device))
        ones = lambda n: _param(torch.ones(n, dtype=dtype, device=device))
        self.bq = zeros(H * hd) if cfg.qkv_bias else None
        self.bk = zeros(Kh * hd) if cfg.qkv_bias else None
        self.bv = zeros(Kh * hd) if cfg.qkv_bias else None
        self.q_norm = ones(hd) if cfg.qk_norm else None
        self.k_norm = ones(hd) if cfg.qk_norm else None


def init_attention(gen, cfg, dtype=torch.float32, device=None) -> Attention:
    return Attention(cfg, gen, dtype, device)


def attention_block(x: torch.Tensor, p: Attention, cfg, *, causal: bool = True,
                    prefix_len: int = 0, positions: Optional[torch.Tensor] = None,
                    kv_cache: Optional[dict] = None, site: str = "attn"):
    """Full attention sub-block. Returns (out, new_kv_cache | None).

    kv_cache: {"k": (B,Hkv,Smax,hd), "v": ..., "len": int} for decode. The
    new k/v are written into the cache tensors in place (the reference
    returns updated copies); the returned cache shares them."""
    B, S, d = x.shape
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, p.wq, site + "_q", p.bq)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = dense(x, p.wk, site + "_k", p.bk)
    v = dense(x, p.wv, site + "_v", p.bv)
    k = k.reshape(B, S, Kh, hd).transpose(1, 2)
    v = v.reshape(B, S, Kh, hd).transpose(1, 2)

    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)

    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        # incremental decode: write k,v at position len, attend to prefix
        ln = kv_cache["len"]
        kfull, vfull = kv_cache["k"], kv_cache["v"]
        kfull[:, :, ln:ln + S] = k.to(kfull.dtype)
        vfull[:, :, ln:ln + S] = v.to(vfull.dtype)
        out = decode_attention(q, kfull, vfull, cache_len=ln + S, site=site)
        new_cache = {"k": kfull, "v": vfull, "len": ln + S}
    else:
        out = attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                        prefix_len=prefix_len, site=site)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return dense(out, p.wo, site + "_o"), new_cache


# ---------------------------------------------------------------------------
# MLP (GLU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d: int, f: int, gen=None, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(gen=gen, dtype=dtype, device=device)
        self.w_in = _normal((d, f), d ** -0.5, **kw)
        self.w_gate = _normal((d, f), d ** -0.5, **kw)
        self.w_out = _normal((f, d), f ** -0.5, **kw)


def init_mlp(gen, d: int, f: int, dtype=torch.float32, device=None) -> MLP:
    return MLP(d, f, gen, dtype, device)


def mlp_block(x: torch.Tensor, p: MLP, cfg, site: str = "mlp") -> torch.Tensor:
    h = dense(x, p.w_in, site + "_in")
    g = dense(x, p.w_gate, site + "_gate")
    h = activate(g, cfg.act) * h
    return dense(h, p.w_out, site + "_out")
