"""Mixture-of-Experts block (counterpart of ``repro.models.moe``, one
device): top-k routing, tokens sorted by expert, and the grouped GLU FFN
through ``dispatch.ragged_gemm`` at the sites ``moe_in``/``moe_gate``/
``moe_out`` (the router is the 2-D ``dispatch.gemm`` site ``moe_router``).

No capacity factor and no token dropping: every (token, expert) pair is
computed, so the expert GEMMs do T*k rows of work. The whole block stays on
the device: no host sync (group sizes by ``scatter_add_``, not
``bincount``, which reads the max on the host), and a combine that sums
each token's k contributions in a fixed order instead of an atomic
``index_add_``, so the bits repeat from run to run. The backward repeats
too: every index op here is a permutation (unique indices, so its
scatter-add backward adds each value into zero once), and each token's k
row gradients are summed by a reduction over a dimension, not by atomics.
The routing gates carry the gradient to ``router``; the sort order and the
group sizes are integers and carry none.

The mesh branches (TP-MoE inside ``shard_map``) and ``moe_block_ep`` come
with multi-device support.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import dispatch

from .layers import _normal, activate


class MoE(nn.Module):
    """router (d, E), w_in / w_gate (E, d, f), w_out (E, f, d), initialized
    as the reference's ``init_moe`` (normal, scaled by fan-in^-1/2)."""

    def __init__(self, d: int, f: int, n_experts: int, gen=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(gen=gen, dtype=dtype, device=device)
        self.router = _normal((d, n_experts), d ** -0.5, **kw)
        self.w_in = _normal((n_experts, d, f), d ** -0.5, **kw)
        self.w_gate = _normal((n_experts, d, f), d ** -0.5, **kw)
        self.w_out = _normal((n_experts, f, d), f ** -0.5, **kw)


def init_moe(gen, d: int, f: int, n_experts: int, dtype=torch.float32,
             device=None) -> MoE:
    return MoE(d, f, n_experts, gen, dtype, device)


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg):
    """Top-k routing. Returns (weights (T,k) f32, ids (T,k) int64)."""
    logits = dispatch.gemm(x_flat, router_w, site="moe_router")
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    weights, ids = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids


def _moe_ffn(x_sorted, group_sizes, cfg, wi, wg, wo):
    """Grouped GLU FFN over expert-sorted rows, one dispatched site per
    GEMM (moe_in / moe_gate / moe_out)."""
    h_in = dispatch.ragged_gemm(x_sorted, wi, group_sizes, site="moe_in")
    h_gate = dispatch.ragged_gemm(x_sorted, wg, group_sizes, site="moe_gate")
    h = activate(h_gate, cfg.act) * h_in
    return dispatch.ragged_gemm(h.to(x_sorted.dtype), wo, group_sizes,
                                site="moe_out")


def _moe_inner(x_flat, router_w, wi, wg, wo, cfg) -> torch.Tensor:
    """Dense tokens (T, d) -> (T, d)."""
    T, d = x_flat.shape
    k = cfg.top_k
    weights, ids = _route(x_flat, router_w, cfg)
    flat_ids = ids.reshape(-1)                               # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    # x_flat[order // k], written as a permutation of the k-fold repeat so
    # that the backward sums each token's k rows in a fixed order
    x_rep = x_flat[:, None, :].expand(T, k, d).reshape(T * k, d)
    x_sorted = x_rep[order]
    group_sizes = torch.zeros(cfg.n_experts, dtype=torch.int32, device=x_flat.device)
    group_sizes.scatter_add_(0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int32))
    out_sorted = _moe_ffn(x_sorted, group_sizes, cfg, wi, wg, wo)
    contrib = out_sorted.to(torch.float32) * weights.reshape(-1)[order][:, None]
    # The reference scatter-adds contrib into token rows; on the CPU that
    # adds each token's rows in ascending sorted position. Undo the sort
    # with the inverse permutation (exact) and add in that order.
    sorted_pos = torch.argsort(order).reshape(T, k)          # row of each (token, slot)
    parts = contrib[torch.sort(sorted_pos, dim=1).values]    # (T, k, d)
    out = torch.zeros((T, d), dtype=torch.float32, device=x_flat.device)
    for i in range(k):
        out = out + parts[:, i]
    return out.to(x_flat.dtype)


def moe_block(x: torch.Tensor, p: MoE, cfg, site: str = "moe") -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), single device."""
    B, S, d = x.shape
    return _moe_inner(x.reshape(-1, d), p.router, p.w_in, p.w_gate, p.w_out,
                      cfg).reshape(B, S, d)
