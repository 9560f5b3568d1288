"""Model assembly (counterpart of ``repro.models.transformer``), dense and
MoE families:

    params = init(cfg, seed, device)               # a Transformer module
    logits = forward(params, cfg, batch)           # train / prefill logits
    cache  = init_cache(cfg, B, max_len)           # serving
    logits, cache = decode_step(params, cfg, cache, tokens)

On a mesh (``dist`` a ``Distribution`` with one; the experts the rank's
slices, ``init(..., dist=)`` or ``launch.sharding.shard_params``) every
rank runs its block: ``forward`` takes the global batch, embeds the rank's
block (``block_of``: the batch split over the dp axes, the sequence over
``tp_axis`` when it splits evenly and is longer than one token) and returns
that block of the logits; ``gather_block`` puts the blocks back together.
``prefill`` takes the global batch too and fills a cache of the rank's rows
(all rows under ``joint_tp``); ``decode_step`` takes and returns those rows.

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

    def __init__(self, cfg: ModelConfig, gen=None, dtype=torch.float32, device=None,
                 expert_take=None):
        super().__init__()
        ones = lambda: L._param(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.attn_norm = ones()
        self.attn = L.init_attention(gen, cfg, dtype, device)
        self.mlp_norm = ones()
        if cfg.n_experts:
            self.moe = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                    dtype, device, expert_take)
        elif cfg.d_ff:
            self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)


class Transformer(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) and one Block per layer.
    With ``gen=None`` the weights are left uninitialized (to be copied in).
    ``expert_take`` cuts each expert tensor to a rank's slice
    (``launch.sharding.expert_take``)."""

    def __init__(self, cfg: ModelConfig, gen=None, dtype=torch.float32, device=None,
                 expert_take=None):
        super().__init__()
        check_family(cfg)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = L._normal((V, d), d ** -0.5, gen, dtype, device)
        self.final_norm = L._param(torch.ones(d, dtype=dtype, device=device))
        self.lm_head = L._normal((d, V), d ** -0.5, gen, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, gen, dtype, device, expert_take)
                                    for _ in range(cfg.n_layers))


def init(cfg: ModelConfig, seed: int = 0, device=None, dist: L.Distribution = L.LOCAL,
         moe_impl: str = "tp") -> Transformer:
    """Random parameters on ``device`` (CUDA unless the caller asks for
    another), drawn in module order from a CPU ``torch.Generator`` seeded
    with ``seed``: the same weights on every device. On a mesh each expert
    tensor is cut to the rank's slice for ``moe_impl`` on the host, after
    its draw and before the move: the slices of the full draw, and no rank
    holds the full experts on the device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    take = None
    if dist.mesh is not None and cfg.n_experts:
        from repro_torch.launch.sharding import expert_take
        take = expert_take(cfg, dist, moe_impl)
    return Transformer(cfg, gen, getattr(torch, cfg.param_dtype), dev, take)


# ---------------------------------------------------------------------------
# The rank's block of the global batch
# ---------------------------------------------------------------------------
def seq_sharded(dist: L.Distribution, S: int) -> bool:
    """Whether a global sequence of S tokens is split over ``tp_axis``: on a
    mesh (not ``joint_tp``) when S > 1 and S % tp == 0, the reference's test
    for sequence parallelism."""
    return (dist.mesh is not None and not dist.joint_tp and dist.tp > 1
            and S > 1 and S % dist.tp == 0)


def block_of(dist: L.Distribution, B: int, S: int) -> tuple:
    """(rows, positions): the slices of a global (B, S) batch the rank runs.
    The batch splits over the dp axes (not under ``joint_tp``, where every
    rank holds it whole), the sequence as ``seq_sharded``."""
    rows, pos = slice(0, B), slice(0, S)
    if dist.mesh is None:
        return rows, pos
    if not dist.joint_tp:
        n = dist.mesh.axis_size(dist.dp_axes)
        if B % n:
            raise ValueError(f"a batch of {B} does not split over {n} ranks of "
                             f"{dist.dp_axes}")
        i = dist.mesh.axis_index(dist.dp_axes)
        rows = slice(i * (B // n), (i + 1) * (B // n))
    if seq_sharded(dist, S):
        s = S // dist.tp
        i = dist.mesh.axis_index(dist.tp_axis)
        pos = slice(i * s, (i + 1) * s)
    return rows, pos


def gather_block(y: torch.Tensor, dist: L.Distribution, S: int) -> torch.Tensor:
    """The global tensor from every rank's block ``y`` (B_rank, S_rank, ...)
    of a global sequence of S tokens (``block_of``'s layout), on every rank."""
    if dist.mesh is None:
        return y
    from repro_torch.parallel.axes import all_gather, use_mesh
    with use_mesh(dist.mesh):
        if seq_sharded(dist, S):
            y = all_gather(y, dist.tp_axis, axis=1, tiled=True)
        if not dist.joint_tp:
            for axis in reversed(dist.dp_axes):
                y = all_gather(y, axis, axis=0, tiled=True)
    return y


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------
def _decoder_block(x, p: Block, cfg, dist: L.Distribution = L.LOCAL, *, positions,
                   prefix_len=0, kv_cache=None, moe_impl: str = "tp",
                   seq_sharded: bool = False):
    """Returns (x, new_kv_cache)."""
    h, new_cache = L.attention_block(
        L.rms_norm(x, p.attn_norm, cfg.norm_eps), p.attn, cfg, dist, causal=True,
        prefix_len=prefix_len, positions=positions, kv_cache=kv_cache,
        seq_sharded=seq_sharded)
    x = x + h
    if cfg.n_experts:
        x = x + MOE.moe_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.moe, cfg, dist,
                              moe_impl=moe_impl, seq_sharded=seq_sharded)
    elif cfg.d_ff:
        x = x + L.mlp_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.mlp, cfg, dist,
                            seq_sharded=seq_sharded)
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
def forward(params: Transformer, cfg: ModelConfig, batch: dict,
            dist: L.Distribution = L.LOCAL, *, remat: str = "block", moe_impl: str = "tp",
            return_hidden: bool = False) -> torch.Tensor:
    """batch: {"tokens": (B, S)}. Returns logits (B, S, padded_vocab) f32, or
    the final-norm hidden states (B, S, d) when ``return_hidden`` (the
    chunked loss computes the head itself). ``remat`` "block" or "full"
    checkpoints every block while gradients are recorded (the recompute
    gives the same bits); "none" keeps every activation. On a mesh the
    global batch goes in and the rank's block comes out (module
    docstring); ``moe_impl`` "tp" or "ep" picks the MoE's parallelism."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat {remat!r} (expected none, block or full)")
    tokens = batch["tokens"]
    S = tokens.shape[1]
    rows, pos = block_of(dist, tokens.shape[0], S)
    sp = seq_sharded(dist, S)
    x = _embed(params, cfg, tokens[rows, pos])
    positions = torch.arange(pos.start, pos.stop, device=x.device)

    def body(h, blk):
        return _decoder_block(h, blk, cfg, dist, positions=positions, moe_impl=moe_impl,
                              seq_sharded=sp)[0]

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
                tokens: torch.Tensor, dist: L.Distribution = L.LOCAL, *,
                moe_impl: str = "tp"):
    """One incremental decode step. tokens: (B, 1) int, the cache's rows (on
    a mesh the rank's, ``block_of``).
    Returns (logits (B, 1, V), new_cache); the cache tensors are updated in
    place and shared with the returned cache.

    ``cache["len"]``, the write cursor, is an int or a 0-d integer tensor on
    the device; with a tensor the step reads no host value, so it can be
    captured in a CUDA graph (``launch.batching``). ``cache["start"]``
    (B,), when present, is the continuous batcher's per-slot lower bound
    of attention."""
    kv_layers = cache["layers"]
    if tokens.shape[0] != kv_layers["k"].shape[1]:
        raise ValueError(f"{tokens.shape[0]} rows of tokens, the cache holds "
                         f"{kv_layers['k'].shape[1]}")
    x = _embed(params, cfg, tokens)
    ln = cache["len"]
    pos = ln + torch.zeros((x.shape[0], 1), dtype=torch.int64, device=x.device)
    start = cache.get("start")
    for i, blk in enumerate(params.layers):
        kv = {"k": kv_layers["k"][i], "v": kv_layers["v"][i], "len": ln, "start": start}
        x, _ = _decoder_block(x, blk, cfg, dist, positions=pos, kv_cache=kv,
                              moe_impl=moe_impl)
    new_cache = {"len": ln + 1, "layers": kv_layers}
    if start is not None:
        new_cache["start"] = start
    return _logits(params, cfg, x), new_cache


@torch.inference_mode()
def prefill(params: Transformer, cfg: ModelConfig, batch: dict, cache: dict,
            dist: L.Distribution = L.LOCAL, *, moe_impl: str = "tp"):
    """Fill the cache from a prompt by running decode_step over positions.
    Returns (last logits (B, V), cache). On a mesh the batch is the global
    one, the cache and the logits the rank's rows (``block_of``)."""
    tokens = batch["tokens"]
    tokens = tokens[block_of(dist, tokens.shape[0], 1)[0]]
    last = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, cache, tokens[:, t:t + 1], dist,
                                    moe_impl=moe_impl)
        last = logits[:, 0]
    return last, cache
