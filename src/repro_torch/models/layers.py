"""Transformer layer substrate (counterpart of ``repro.models.layers``).
Every matmul routes through ``repro_torch.core.dispatch`` so numerics
policies apply to the whole model.

Layouts are the reference's: weights (K, N) with ``dense(x, w) = gemm(x,
w)``; q/k/v (B, H, S, hd). Parameters live in ``nn.Module``s whose
attribute names are the reference's dict keys.

On a mesh (``Distribution`` with one) the blocks run explicit SPMD: each
rank's activation is its block of the reference's global tensor, in the
layout the reference's sharding constraint names at that point (batch over
the dp axes; the sequence over ``tp_axis`` when ``seq_sharded``), and data
moves only where that layout changes, through the named collectives of
``parallel.axes`` (differentiable; their adjoints are listed there).
Weights are replicated, apart from the experts (``launch.sharding``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch
from repro_torch.parallel.axes import all_gather, axis_index, pvary, shard, use_mesh


# ---------------------------------------------------------------------------
# Distribution context: optional mesh + constraint helper
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Distribution:
    """The reference's ``Distribution``, field for field. Without a mesh it
    is the single-device run (``LOCAL``). With one, the blocks run the
    rank's block of every activation (module docstring); data parallelism
    alone runs the whole model a rank (``train.loop.make_mesh_train_step``).
    The parameters may be whole on every rank or placed, each rank holding
    its block of every weight (``launch.sharding.param_specs``) and every
    unit gathering its leaves on use: the blocks read the same weights
    either way. The serve CLI's ``--mesh``/``--profile`` places them."""

    mesh: object = None                       # launch.mesh.DeviceMesh | None
    dp_axes: tuple = ("data",)                # batch axes (may include "pod")
    tp_axis: Optional[str] = "model"          # tensor/sequence-parallel axis
    mlp_pattern: str = "sp"                   # "megatron" | "sp"
    joint_tp: bool = False                    # the decode_tp profile
    numerics_policy: object = None            # the deployed plan's policy

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def tp(self) -> int:
        """Ranks along ``tp_axis`` (1 without a mesh)."""
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.axis_size(self.tp_axis)

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The identity, with a mesh too: at the reference's call sites the
        rank's block already has the placement ``spec`` names (the blocks
        move data explicitly where the layout changes)."""
        return x


LOCAL = Distribution()


def _param(t: torch.Tensor) -> nn.Parameter:
    # Trainable: the dispatch sites carry gradients through their backward
    # GEMMs. Serving runs under torch.inference_mode() and builds no graph.
    return nn.Parameter(t, requires_grad=True)


def _normal(shape, scale, gen, dtype, device, take=None) -> nn.Parameter:
    """A parameter drawn from ``gen``, a CPU generator, on the CPU, moved to
    ``device`` and scaled there, so that one seed gives the same weights on
    every device (a correctly rounded multiply gives the same bits on both).
    The host holds one tensor at a time. ``take``, when given, cuts the host
    draw to the rank's slice before the move (``launch.sharding``), so the
    slice is the full draw's. ``gen=None`` leaves it uninitialized (to be
    copied in), at the slice's shape."""
    if gen is None:
        if take is not None:
            shape = take(torch.empty(shape, device="meta")).shape
        return _param(torch.empty(shape, dtype=dtype, device=device))
    t = torch.randn(shape, generator=gen, dtype=dtype)
    if take is not None:
        t = take(t).contiguous()
    return _param(t.to(device).mul_(scale))


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``layer_norm`` (which no model calls): the population
    variance of the last axis, in f32."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


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
                     cache_len, start: Optional[torch.Tensor] = None,
                     site: str = "attn") -> torch.Tensor:
    """Single-step attention against a (possibly longer-than-valid) KV
    cache. q: (B, H, 1, hd); k, v: (B, Hkv, Smax, hd); cache_len: valid
    prefix, an int or a 0-d integer tensor on the device, so that a
    captured step reads it at replay. ``start`` (B,): continuous batching,
    a slot reused mid-stream attends only to its own request's prefix
    [start, cache_len). (The int8 cache with scales comes with a later
    slice.)"""
    B, H, Sq, hd = q.shape
    Hkv, Smax = k.shape[1], k.shape[2]
    qv = q.reshape(B, Hkv, H // Hkv, Sq, hd)
    s = dispatch.grouped_qk(qv, k, site=site + "_qk").to(torch.float32) * hd ** -0.5
    pos = torch.arange(Smax, device=q.device)[None, :]
    valid = pos < cache_len
    if start is not None:
        valid = valid & (pos >= start[:, None])
    s = torch.where(valid[:, None, None, None, :], s, -torch.inf)
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


def attention_block(x: torch.Tensor, p: Attention, cfg, dist: Distribution = LOCAL, *,
                    causal: bool = True, prefix_len: int = 0,
                    positions: Optional[torch.Tensor] = None,
                    kv_cache: Optional[dict] = None,
                    kv_override: Optional[tuple] = None, site: str = "attn",
                    seq_sharded: bool = False):
    """Full attention sub-block. Returns (out, new_kv_cache | None).

    kv_cache: {"k": (B,Hkv,Smax,hd), "v": ..., "len": int or 0-d integer
    tensor on the device, "start": optional (B,)} for decode. The new k/v
    are written into the cache tensors in place at positions [len, len + S)
    (``index_copy_`` at a device index: the reference returns updated
    copies); the returned cache shares them.

    kv_override: precomputed (k, v), each (B, Hkv, Sk, hd) (whisper's
    cross-attention): only q is projected from x, neither side gets RoPE,
    and the sites are the self-attention's (``site``), as in the reference.

    With ``seq_sharded`` (a mesh, x the rank's block of S / tp positions, no
    cache), q stays the rank's block and K and V are all-gathered over
    ``tp_axis`` along the sequence, as the reference's constraints place
    them: the block's positions, for RoPE and the causal mask, start at
    ``axis_index(tp) * S``. Otherwise every rank attends its own rows."""
    B, S, d = x.shape
    sp = seq_sharded and kv_cache is None and dist.tp > 1
    offset = dist.mesh.axis_index(dist.tp_axis) * S if sp else 0
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, p.wq, site + "_q", p.bq)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    if kv_override is not None:
        k, v = kv_override
    else:
        k = dense(x, p.wk, site + "_k", p.bk)
        v = dense(x, p.wv, site + "_v", p.bv)
        k = k.reshape(B, S, Kh, hd).transpose(1, 2)
        v = v.reshape(B, S, Kh, hd).transpose(1, 2)

    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)

    if positions is None:
        positions = offset + torch.arange(S, device=x.device)
    if kv_override is None:                   # no RoPE on cross-attention
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if sp:
        # SP: q stays sequence-sharded; K/V are the (all-gathered) small side
        with use_mesh(dist.mesh):
            k = all_gather(k, dist.tp_axis, axis=2, tiled=True)
            v = all_gather(v, dist.tp_axis, axis=2, tiled=True)

    new_cache = None
    if kv_cache is not None:
        # incremental decode: write k,v at position len, attend to prefix
        ln = kv_cache["len"]
        kfull, vfull = kv_cache["k"], kv_cache["v"]
        idx = ln + torch.arange(S, device=x.device)
        kfull.index_copy_(2, idx, k.to(kfull.dtype))
        vfull.index_copy_(2, idx, v.to(vfull.dtype))
        out = decode_attention(q, kfull, vfull, cache_len=ln + S,
                               start=kv_cache.get("start"), site=site)
        new_cache = {"k": kfull, "v": vfull, "len": ln + S}
    else:
        out = attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                        prefix_len=prefix_len, q_offset=offset, site=site)
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


def mlp_block(x: torch.Tensor, p: MLP, cfg, dist: Distribution = LOCAL,
              site: str = "mlp", *, seq_sharded: bool = False) -> torch.Tensor:
    """The GLU MLP. On a mesh, the reference's two patterns: ``"sp"`` with
    the sequence sharded runs the rank's rows against the replicated
    weights; otherwise (decode always) the Megatron form: ``w_in``/``w_gate``
    sliced by columns and ``w_out`` by rows over ``tp_axis``, the output
    summed over it by ``gemm(reduce_axis=)`` on the rows flattened to 2-D,
    exactly (``fdp_psum``) in the FDP modes. A sharded sequence is
    all-gathered first and the rank's block kept after."""
    n = dist.tp
    if n == 1 or (dist.mlp_pattern == "sp" and seq_sharded):
        h = dense(x, p.w_in, site + "_in")
        g = dense(x, p.w_gate, site + "_gate")
        h = activate(g, cfg.act) * h
        return dense(h, p.w_out, site + "_out")
    tp = dist.tp_axis
    f = p.w_in.shape[1]
    if f % n:
        raise ValueError(f"the Megatron MLP splits d_ff {f} over {n} ranks of {tp!r}")
    with use_mesh(dist.mesh):
        fl, i = f // n, axis_index(tp)
        cols = slice(i * fl, (i + 1) * fl)
        xf = all_gather(x, tp, axis=1, tiled=True) if seq_sharded else pvary(x, tp)
        h = dense(xf, p.w_in[:, cols], site + "_in")
        g = dense(xf, p.w_gate[:, cols], site + "_gate")
        h = activate(g, cfg.act) * h
        B, S = h.shape[:2]
        out = dispatch.gemm(h.reshape(B * S, fl), p.w_out[cols], site=site + "_out",
                            reduce_axis=tp).reshape(B, S, -1).to(x.dtype)
        return shard(out, tp, 1) if seq_sharded else out
