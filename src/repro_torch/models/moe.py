"""Mixture-of-Experts block (counterpart of ``repro.models.moe``): top-k
routing, tokens sorted by expert, and the grouped GLU FFN
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

On a mesh (``Distribution`` with one) ``moe_block`` runs the reference's
three TP branches on the rank's block and its slice of every expert's d_ff
(``launch.sharding`` cuts it): the sequence-sharded one all-gathers the
sequence over ``tp_axis``, runs the local block on the rank's f-slice and
reduce-scatters the partial outputs back to sequence blocks; ``joint_tp``
(the decode_tp profile) holds the whole batch on every rank, f sliced over
the flattened (dp..., tp) axes, and sums the partials over all of them; the
decode branch sums them over ``tp_axis``. The partials are floats, so these
agree with the local block to rounding, not bit for bit.
``moe_block_ep`` is expert parallelism: the rank owns E / tp whole experts,
sends its rows to their experts' ranks in capacity slots with one
all-to-all (and their expert ids with another), and gets the outputs back
with a third. Each token's contributions are summed in ascending sorted
position, the local block's order, so wherever the expert GEMM rounds each
row on its own (the FDP modes) it is bit-equal to the local block.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.core import dispatch
from repro_torch.parallel.axes import (all_gather, all_to_all, axis_index, psum,
                                       psum_scatter, pvary, use_mesh)

from .layers import LOCAL, Distribution, _normal, activate


class MoE(nn.Module):
    """router (d, E), w_in / w_gate (E, d, f), w_out (E, f, d), initialized
    as the reference's ``init_moe`` (normal, scaled by fan-in^-1/2).
    ``take(name, tensor)``, when given, cuts each expert tensor's host draw
    to a rank's slice (``launch.sharding.expert_take``)."""

    def __init__(self, d: int, f: int, n_experts: int, gen=None,
                 dtype=torch.float32, device=None, take=None):
        super().__init__()
        kw = dict(gen=gen, dtype=dtype, device=device)
        cut = lambda name: None if take is None else functools.partial(take, name)
        self.router = _normal((d, n_experts), d ** -0.5, **kw)
        self.w_in = _normal((n_experts, d, f), d ** -0.5, **kw, take=cut("w_in"))
        self.w_gate = _normal((n_experts, d, f), d ** -0.5, **kw, take=cut("w_gate"))
        self.w_out = _normal((n_experts, f, d), f ** -0.5, **kw, take=cut("w_out"))


def init_moe(gen, d: int, f: int, n_experts: int, dtype=torch.float32,
             device=None, take=None) -> MoE:
    return MoE(d, f, n_experts, gen, dtype, device, take)


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


def joint_axes(dist: Distribution) -> tuple:
    """The axes ``joint_tp`` slices d_ff over, in the flattened rank order."""
    return tuple(dist.dp_axes) + (dist.tp_axis,)


def expert_split(cfg, dist: Distribution, moe_impl: str = "tp") -> tuple:
    """(experts, f) a rank holds: (E, f) without a mesh; (E, f / n) for TP,
    n = tp or, under ``joint_tp``, the joint axes' size; (E / tp, f) for
    EP."""
    E, f = cfg.n_experts, cfg.d_ff
    if dist.mesh is None:
        return E, f
    if moe_impl == "ep":
        if E % dist.tp:
            raise ValueError(f"expert parallelism needs n_experts {E} % tp {dist.tp} == 0")
        return E // dist.tp, f
    if moe_impl != "tp":
        raise ValueError(f"moe_impl {moe_impl!r} (expected tp or ep)")
    n = dist.mesh.axis_size(joint_axes(dist)) if dist.joint_tp else dist.tp
    if f % n:
        raise ValueError(f"d_ff {f} does not split over {n} ranks")
    return E, f // n


def _check_experts(p: MoE, cfg, dist: Distribution, moe_impl: str) -> None:
    E, f = expert_split(cfg, dist, moe_impl)
    d = cfg.d_model
    want = ((E, d, f), (E, d, f), (E, f, d))
    got = tuple(tuple(w.shape) for w in (p.w_in, p.w_gate, p.w_out))
    if got != want:
        raise ValueError(
            f"the experts' w_in, w_gate, w_out are {got}; moe_impl {moe_impl!r} on "
            f"{'no mesh' if dist.mesh is None else 'mesh ' + dist.mesh.describe()} "
            f"wants {want} (launch.sharding.shard_params cuts a rank's slices)")


def moe_block(x: torch.Tensor, p: MoE, cfg, dist: Distribution = LOCAL,
              site: str = "moe", *, moe_impl: str = "tp",
              seq_sharded: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), the rank's block (module docstring).
    ``seq_sharded``: x holds the rank's S of the global sequence split over
    ``tp_axis``. ``moe_impl="ep"`` runs ``moe_block_ep``. The experts must
    be the rank's slices for ``dist`` and ``moe_impl``, else ValueError."""
    if moe_impl == "ep" and dist.mesh is not None:
        return moe_block_ep(x, p, cfg, dist, site, seq_sharded=seq_sharded)
    _check_experts(p, cfg, dist, "tp")
    B, S, d = x.shape

    def inner(xl):
        return _moe_inner(xl.reshape(-1, d), p.router, p.w_in, p.w_gate, p.w_out,
                          cfg).reshape(xl.shape)

    if dist.mesh is None:
        return inner(x)
    tp = dist.tp_axis
    with use_mesh(dist.mesh):
        if dist.joint_tp:
            # weights-stay-put decode: every rank computes every token against
            # its 1/(dp*tp) slice of the experts' f; partials summed over all
            axes = joint_axes(dist)
            return psum(inner(pvary(x, axes)), axes)
        if dist.tp == 1:
            return inner(x)
        if seq_sharded:
            # gather the sequence over tp, the rank's f-slice over every
            # token of its rows, then reduce and re-scatter the sequence
            y = inner(all_gather(x, tp, axis=1, tiled=True))
            return psum_scatter(y, tp, scatter_dimension=1, tiled=True)
        # decode: the sequence too short to shard; partials summed over tp
        return psum(inner(pvary(x, tp)), tp)


def moe_block_ep(x: torch.Tensor, p: MoE, cfg, dist: Distribution, site: str = "moe",
                 capacity_factor: float = 2.0, *, seq_sharded: bool = True,
                 return_dropped: bool = False):
    """Expert-parallel MoE (module docstring): x (B, S, d) the rank's (dp, tp)
    block, the rank's E / tp experts in ``p``. A destination rank takes at
    most ``cap = int(capacity_factor * T * k / tp) + 1`` of a rank's T * k
    (token, expert) rows; the rest are dropped (their contribution is 0).
    With ``return_dropped`` it returns (out, rows dropped on this rank, a
    0-d device tensor). Without a mesh it is ``moe_block``."""
    if dist.mesh is None:
        out = moe_block(x, p, cfg, dist, site)
        return (out, torch.zeros((), dtype=torch.int64, device=x.device)) \
            if return_dropped else out
    _check_experts(p, cfg, dist, "ep")
    n, tp = dist.tp, dist.tp_axis
    if n > 1 and not seq_sharded:
        raise ValueError(f"expert parallelism shards the sequence over {tp!r}: a "
                         f"sequence that does not split over its {n} ranks cannot run")
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    e_loc = E // n
    dev = x.device
    with use_mesh(dist.mesh):
        xf = x.reshape(-1, d)
        T = xf.shape[0]
        weights, ids = _route(xf, p.router, cfg)
        flat_ids = ids.reshape(-1)                               # (T*k,)
        order = torch.argsort(flat_ids, stable=True)             # expert(=>rank)-sorted
        token_of = order // k
        ids_sorted = flat_ids[order]
        per_rank = torch.zeros(n, dtype=torch.int64, device=dev)
        per_rank.scatter_add_(0, flat_ids // e_loc, torch.ones_like(flat_ids))
        offs = torch.cumsum(per_rank, 0) - per_rank
        cap = int(capacity_factor * (T * k) / n) + 1
        slot = torch.arange(n * cap, device=dev)
        rank_of, j = slot // cap, slot % cap
        valid = j < per_rank[rank_of]
        src = torch.clamp(offs[rank_of] + j, max=T * k - 1)     # sorted position a slot
        send_x = torch.where(valid[:, None], xf[token_of[src]], 0.0)
        send_id = torch.where(valid, ids_sorted[src], -1)
        recv_x = all_to_all(send_x.reshape(n, cap, d), tp, 0, 0, tiled=True)
        recv_id = dist.mesh.all_to_all(send_id.reshape(n, cap), tp, 0, 0)
        loc_id = torch.where(recv_id >= 0, recv_id - axis_index(tp) * e_loc,
                             e_loc).reshape(-1)
        lorder = torch.argsort(loc_id, stable=True)
        lsorted = recv_x.reshape(-1, d)[lorder]
        lsizes = torch.zeros(e_loc + 1, dtype=torch.int32, device=dev)
        lsizes.scatter_add_(0, loc_id, torch.ones_like(loc_id, dtype=torch.int32))
        lsizes = lsizes[:e_loc]
        out_sorted = _moe_ffn(lsorted, lsizes, cfg, p.w_in, p.w_gate, p.w_out)
        # rows past the routed total are 0 (the ragged GEMM writes them so);
        # undo the local sort (a permutation) and send the rows back
        back = out_sorted[torch.argsort(lorder)]
        ret = all_to_all(back.reshape(n, cap, d), tp, 0, 0, tiled=True).reshape(-1, d)
        # each (token, slot) pair's slot: its sorted position p sits at
        # rank(p) * cap + p - offs[rank(p)], kept while that is under cap
        sorted_pos = torch.argsort(order).reshape(T, k)
        pos = torch.sort(sorted_pos, dim=1).values              # ascending, as local
        r_of = ids_sorted[pos] // e_loc
        jj = pos - offs[r_of]
        kept = jj < cap
        slot_of = r_of * cap + torch.clamp(jj, max=cap - 1)
        w_sorted = weights.reshape(-1)[order]
        parts = ret.to(torch.float32)[slot_of] * w_sorted[pos][..., None]
        parts = torch.where(kept[..., None], parts, 0.0)        # (T, k, d)
        out = torch.zeros((T, d), dtype=torch.float32, device=dev)
        for i in range(k):
            out = out + parts[:, i]
        out = out.to(x.dtype).reshape(B, S, d)
    if return_dropped:
        return out, (~kept).sum()
    return out
