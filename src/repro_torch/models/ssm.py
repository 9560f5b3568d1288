"""Mamba-2 (SSD, state-space duality) block, chunked algorithm
(counterpart of ``repro.models.ssm``; arXiv:2405.21060 §6).

The sequence is split into chunks; within a chunk the dual quadratic
(attention-like) form is used, across chunks a linear recurrence carries the
(heads, head_dim, state) SSM state. Heads are kept factored as (groups g,
heads-per-group e) so B/C (shared per group) never materialize per head.

Numerics: the six projections (``ssm_x``/``ssm_z``/``ssm_B``/``ssm_C``/
``ssm_dt``/``ssm_out``) run through the dispatch layer, so under an FDP
policy every one of them is an FDP GEMM (the dense kernel in ``pallas``
mode). The conv, the cumulative sums and the SSD einsums are plain tensor
algebra in f32, as in the reference, whose float order this follows where
it is cheap to: the conv sums its taps in order from 0, softplus is
``logaddexp(x, 0)``, and the casts are the reference's. The chunk
recurrence is a Python loop in place of ``lax.scan``.

With a cache (serving) the conv and SSM states are written into the cache
tensors in place, as the KV cache is (``layers.attention_block``).

On a mesh the block raises: the reference's channel-sharded branch waits for
ROADMAP queue 1, *Multi-device*, the sharded SSM.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LOCAL, Distribution, _normal, _param, dense, rms_norm

CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "state")


class SSM(nn.Module):
    """Parameters of one Mamba-2 block, named as ``init_ssm``'s keys and
    drawn in that order."""

    def __init__(self, cfg, gen=None, dtype=torch.float32, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        g, n, h, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        kw = dict(gen=gen, dtype=dtype, device=device)
        s = d ** -0.5
        self.in_x = _normal((d, di), s, **kw)
        self.in_z = _normal((d, di), s, **kw)
        self.in_B = _normal((d, g * n), s, **kw)
        self.in_C = _normal((d, g * n), s, **kw)
        self.in_dt = _normal((d, h), s, **kw)
        self.conv_x = _normal((w, di), w ** -0.5, **kw)
        self.conv_B = _normal((w, g * n), w ** -0.5, **kw)
        self.conv_C = _normal((w, g * n), w ** -0.5, **kw)
        full = lambda n_, v: _param(torch.full((n_,), v, dtype=dtype, device=device))
        self.A_log = full(h, 0.0)              # A = -exp(A_log) = -1
        self.D = full(h, 1.0)
        self.dt_bias = full(h, 0.0)
        self.norm = full(di, 1.0)
        self.out = _normal((di, d), di ** -0.5, **kw)


def _causal_conv(x: torch.Tensor, kern: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, C), kern: (w, C). state: (B, w-1, C)
    trailing inputs from the previous segment (decode). Returns (silu(y),
    new_state)."""
    w = kern.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], w - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * kern[i] for i in range(w))
    new_state = xp[:, -(w - 1):, :] if w > 1 else state
    return F.silu(y), new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> lower-triangular pairwise sums L[q,k] = sum_{k<i<=q} a_i,
    -inf above the diagonal (exp -> 0)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    dlt = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, dlt, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None):
    """SSD scan. x: (b, l, h, p); dt: (b, l, h); A: (h,) (the log of -A);
    B, C: (b, l, g, n). Returns (y (b,l,h,p), final_state (b,g,e,p,n) f32)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    e = h // g
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    c = x.shape[1] // chunk
    xc = x.reshape(b, c, chunk, g, e, p)
    dtc = dt.reshape(b, c, chunk, g, e)
    Bc = B.reshape(b, c, chunk, g, n)
    Cc = C.reshape(b, c, chunk, g, n)
    Ac = dtc * (-torch.exp(A.to(torch.float32))).reshape(g, e)      # (b,c,Q,g,e)
    x_dt = (xc * dtc[..., None]).to(torch.float32)

    A_cum = torch.cumsum(Ac, dim=2)                                  # (b,c,Q,g,e)
    # intra-chunk (dual quadratic form)
    Lt = torch.exp(_segsum(torch.movedim(Ac, 2, -1)))                # (b,c,g,e,Q,Q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    y_diag = torch.einsum("bcgqk,bcgeqk,bckgep->bcqgep", scores, Lt, x_dt)
    # chunk -> state contributions
    decay_states = torch.exp(A_cum[:, :, -1:] - A_cum)               # (b,c,Q,g,e)
    states = torch.einsum("bckgn,bckge,bckgep->bcgepn", Bc, decay_states, x_dt)
    chunk_decay = torch.exp(A_cum[:, :, -1])                         # (b,c,g,e)

    S = (init_state.to(torch.float32) if init_state is not None
         else torch.zeros((b, g, e, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for i in range(c):                   # the state BEFORE each chunk
        prev.append(S)
        S = S * chunk_decay[:, i, ..., None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                           # (b,c,g,e,p,n)
    # inter-chunk contribution
    state_decay = torch.exp(A_cum)                                   # (b,c,Q,g,e)
    y_off = torch.einsum("bcqgn,bcgepn,bcqge->bcqgep", Cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(b, c * chunk, h, p)[:, :l]
    return y.to(x.dtype), S


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor, A: torch.Tensor,
             B_t: torch.Tensor, C_t: torch.Tensor):
    """Single-token SSD recurrence. state: (b,g,e,p,n); x_t: (b,h,p);
    dt_t: (b,h); B_t, C_t: (b,g,n). Returns (y (b,h,p), new_state)."""
    b, g, e, p, n = state.shape
    xg = x_t.reshape(b, g, e, p).to(torch.float32)
    dtg = dt_t.reshape(b, g, e)
    Ag = (-torch.exp(A.to(torch.float32))).reshape(g, e)
    da = torch.exp(dtg * Ag)                                         # (b,g,e)
    upd = torch.einsum("bgn,bgep->bgepn", B_t.to(torch.float32), xg * dtg[..., None])
    state = state * da[..., None, None] + upd
    y = torch.einsum("bgn,bgepn->bgep", C_t.to(torch.float32), state)
    return y.reshape(b, g * e, p).to(x_t.dtype), state


def ssm_block(x: torch.Tensor, p: SSM, cfg, dist: Distribution = LOCAL, *,
              cache: Optional[dict] = None, site: str = "ssm"):
    """Full Mamba-2 block. x: (B, S, d). cache (decode): {"conv_x", "conv_B",
    "conv_C": (B, w-1, ·), "state": (B, g, e, p, n) f32}, updated in place and
    returned. Returns (out, cache | None)."""
    if dist.mesh is not None:
        raise NotImplementedError(
            f"{cfg.name}: the SSM block on a mesh is not ported yet; ROADMAP queue 1, "
            f"*Multi-device*, the sharded SSM, brings it")
    B_, S, d = x.shape
    g, n, h, pdim = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xz = dense(x, p.in_x, site + "_x")
    z = dense(x, p.in_z, site + "_z")
    Bp = dense(x, p.in_B, site + "_B")
    Cp = dense(x, p.in_C, site + "_C")
    dt = dense(x, p.in_dt, site + "_dt").to(torch.float32) + p.dt_bias
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype, device=dt.device))  # softplus

    cc = cache or {}
    xz, cx = _causal_conv(xz, p.conv_x, cc.get("conv_x"))
    Bp, cb = _causal_conv(Bp, p.conv_B, cc.get("conv_B"))
    Cp, cv = _causal_conv(Cp, p.conv_C, cc.get("conv_C"))

    xh = xz.reshape(B_, S, h, pdim)
    Bh = Bp.reshape(B_, S, g, n)
    Ch = Cp.reshape(B_, S, g, n)

    if cache is not None and S == 1:
        y, state = ssd_step(cc["state"], xh[:, 0], dt[:, 0], p.A_log, Bh[:, 0], Ch[:, 0])
        y = y[:, None]
    else:
        y, state = ssd_chunked(xh, dt, p.A_log, Bh, Ch, chunk=min(64, max(8, S)),
                               init_state=cc.get("state"))
    y = y.reshape(B_, S, h * pdim) + xz * torch.repeat_interleave(p.D, pdim).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = dense(y, p.out, site + "_out")
    if cache is None:
        return out, None
    for key, new in zip(CACHE_KEYS, (cx, cb, cv, state)):
        cache[key].copy_(new)
    return out, {key: cache[key] for key in CACHE_KEYS}
