"""Model assembly (counterpart of ``repro.models.transformer``), every
family: dense, MoE, SSM (Mamba-2), hybrid (Zamba2: SSM layers with one
weight-shared attention + MLP block after every ``attn_every`` of them),
encdec (whisper: an encoder over ``frames``, decoder blocks with a
cross-attention to its output) and vlm (PaliGemma: ``patches`` ahead of the
text, a bidirectional prefix over them):

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
The SSM and hybrid families raise on a mesh (``ssm.ssm_block``), the
encdec and vlm families too (``refuse_mesh``).

Placed parameters (``init(..., profile=)`` or ``launch.sharding.place``):
each rank holds its block of every weight (``launch.sharding.param_specs``)
and each unit gathers its leaves just before it runs and drops them after
(``parallel.placement.gathered``): a block in ``_decoder_block``, the
embedding in ``_embed``, ``final_norm`` with the head in ``_logits``. The
blocks read the gathered weights as they read replicated ones.

Parameters map one-to-one onto the reference's tree: its ``layers.*``
leaves carry a leading layer axis (two for ``hybrid``: group, then position
in the group), here ``layers[i].*`` is one module per layer, layer ``i``
being group ``i // attn_every``, position ``i % attn_every``, and
``shared.*`` the hybrid's one shared block; an encdec model has
``enc_layers[i]``, ``dec_layers[i]`` and ``enc_norm`` in place of
``layers`` (``models.convert`` unstacks and restacks). Layers run as a
Python loop in place of the reference's ``scan``; ``remat`` checkpoints
each block (``dispatch.checkpoint``, whose
recompute re-enters the forward's policy), where the reference remats a
hybrid's whole group: the recompute gives the same bits either way.

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
from repro_torch.parallel.placement import attach, gathered

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig, check_family

SSM_FAMILIES = ("ssm", "hybrid")
# families whose sharded forward is not ported (the SSM's raise in ssm_block)
MESHLESS_FAMILIES = ("encdec", "vlm")


def refuse_mesh(cfg: ModelConfig, dist: L.Distribution) -> None:
    """Raise on a mesh for the encdec and vlm families."""
    if dist.mesh is not None and cfg.family in MESHLESS_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh is not ported yet; ROADMAP "
            f"queue 1, *Multi-device*, the sharded encoder-decoder and VLM, brings it")


class Block(nn.Module):
    """One decoder block: attn_norm, attn, (cross_norm, cross with
    ``cross``: whisper's decoder), mlp_norm, then moe (when the config has
    experts) or mlp; for the SSM families ssm_norm and ssm."""

    def __init__(self, cfg: ModelConfig, gen=None, dtype=torch.float32, device=None,
                 expert_take=None, *, cross: bool = False):
        super().__init__()
        ones = lambda: L._param(torch.ones(cfg.d_model, dtype=dtype, device=device))
        if cfg.family in SSM_FAMILIES:
            self.ssm_norm = ones()
            self.ssm = SSM.SSM(cfg, gen, dtype, device)
            return
        self.attn_norm = ones()
        self.attn = L.init_attention(gen, cfg, dtype, device)
        if cross:
            self.cross_norm = ones()
            self.cross = L.init_attention(gen, cfg, dtype, device)
        self.mlp_norm = ones()
        if cfg.n_experts:
            self.moe = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                    dtype, device, expert_take)
        elif cfg.d_ff:
            self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)


class SharedBlock(nn.Module):
    """The hybrid's weight-tied attention + MLP block: attn_norm, attn,
    mlp_norm, mlp."""

    def __init__(self, cfg: ModelConfig, gen=None, dtype=torch.float32, device=None):
        super().__init__()
        ones = lambda: L._param(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.attn_norm = ones()
        self.attn = L.init_attention(gen, cfg, dtype, device)
        self.mlp_norm = ones()
        self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)


def n_groups(cfg: ModelConfig) -> int:
    """The hybrid's groups of ``attn_every`` SSM layers, each followed by the
    shared block."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups "
                         f"of attn_every={cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


class Transformer(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V), one Block per layer and,
    for ``hybrid``, the shared block (drawn last); for ``encdec`` the
    encoder's blocks (``enc_layers``, ``n_enc_layers`` of them), then the
    decoder's with cross-attention (``dec_layers``, ``n_layers``), then
    ``enc_norm``. With ``gen=None`` the weights are left uninitialized (to
    be copied in). ``expert_take`` cuts each expert tensor to a rank's slice
    (``launch.sharding.expert_take``). ``place(name, unit)``, when given
    (dense and moe families), takes each unit drawn whole on the host (a
    top-level parameter, a block) and returns it on ``device`` cut to the
    rank's blocks (``launch.sharding.placer``): the host holds one unit at
    a time."""

    def __init__(self, cfg: ModelConfig, gen=None, dtype=torch.float32, device=None,
                 expert_take=None, place=None):
        super().__init__()
        check_family(cfg)
        keep = (lambda name, unit: unit) if place is None else place
        if place is not None:
            device = torch.device("cpu")
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = keep("embed", L._normal((V, d), d ** -0.5, gen, dtype, device))
        self.final_norm = keep("final_norm",
                               L._param(torch.ones(d, dtype=dtype, device=device)))
        self.lm_head = keep("lm_head", L._normal((d, V), d ** -0.5, gen, dtype, device))
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(Block(cfg, gen, dtype, device)
                                            for _ in range(cfg.n_enc_layers))
            self.dec_layers = nn.ModuleList(Block(cfg, gen, dtype, device, cross=True)
                                            for _ in range(cfg.n_layers))
            self.enc_norm = L._param(torch.ones(d, dtype=dtype, device=device))
            return
        if cfg.family == "hybrid":
            n_groups(cfg)                   # raises unless the layers split into groups
        self.layers = nn.ModuleList(keep(f"layers.{i}", Block(cfg, gen, dtype, device, expert_take))
                                    for i in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = SharedBlock(cfg, gen, dtype, device)


def init(cfg: ModelConfig, seed: int = 0, device=None, dist: L.Distribution = L.LOCAL,
         moe_impl: str = "tp", profile: str = None) -> Transformer:
    """Random parameters on ``device`` (CUDA unless the caller asks for
    another), drawn in module order from a CPU ``torch.Generator`` seeded
    with ``seed``: the same weights on every device. On a mesh each expert
    tensor is cut to the rank's slice for ``moe_impl`` on the host, after
    its draw and before the move: the slices of the full draw, and no rank
    holds the full experts on the device. With ``profile`` (a launch
    profile, ``dist`` its ``distribution_for``) every parameter is placed
    instead: each unit is drawn on the host and cut to the rank's blocks of
    ``launch.sharding.param_specs`` before the move (module docstring)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    if profile is not None:
        from repro_torch.launch.sharding import placer
        if moe_impl != "tp":
            raise ValueError(f"placed experts are read as TP slices, not moe_impl {moe_impl!r}")
        place, shardings = placer(cfg, dist, profile, dev)
        return attach(Transformer(cfg, gen, dtype, dev, place=place), shardings)
    take = None
    if dist.mesh is not None and cfg.n_experts:
        from repro_torch.launch.sharding import expert_take
        take = expert_take(cfg, dist, moe_impl)
    return Transformer(cfg, gen, dtype, dev, take)


def init_abstract(cfg: ModelConfig) -> Transformer:
    """The parameters' names, shapes and dtypes with no storage (the
    ``meta`` device), as the reference's ``init_abstract``."""
    return Transformer(cfg, None, getattr(torch, cfg.param_dtype), torch.device("meta"))


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
                   prefix_len=0, kv_cache=None, enc_out=None, moe_impl: str = "tp",
                   seq_sharded: bool = False):
    """Returns (x, new_kv_cache). ``enc_out``: the layer's cross K/V, each
    (B, Hkv, enc_seq, hd), attended after the self-attention. A placed
    block's leaves are gathered first (module docstring)."""
    p = gathered(p)
    if cfg.family in SSM_FAMILIES:
        h, new_cache = SSM.ssm_block(L.rms_norm(x, p.ssm_norm, cfg.norm_eps), p.ssm, cfg,
                                     dist, cache=kv_cache)
        return x + h, new_cache
    h, new_cache = L.attention_block(
        L.rms_norm(x, p.attn_norm, cfg.norm_eps), p.attn, cfg, dist, causal=True,
        prefix_len=prefix_len, positions=positions, kv_cache=kv_cache,
        seq_sharded=seq_sharded)
    x = x + h
    if enc_out is not None:
        h, _ = L.attention_block(L.rms_norm(x, p.cross_norm, cfg.norm_eps), p.cross, cfg,
                                 dist, causal=False, kv_override=enc_out)
        x = x + h
    if cfg.n_experts:
        x = x + MOE.moe_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.moe, cfg, dist,
                              moe_impl=moe_impl, seq_sharded=seq_sharded)
    elif cfg.d_ff:
        x = x + L.mlp_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.mlp, cfg, dist,
                            seq_sharded=seq_sharded)
    return x, new_cache


def _encoder_block(x, p: Block, cfg, dist: L.Distribution = L.LOCAL):
    """Whisper's encoder block: non-causal self-attention (RoPE over the
    frame positions), then the MLP."""
    h, _ = L.attention_block(L.rms_norm(x, p.attn_norm, cfg.norm_eps), p.attn, cfg, dist,
                             causal=False)
    x = x + h
    return x + L.mlp_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.mlp, cfg, dist)


def _cross_kv(enc: torch.Tensor, p: Block, cfg) -> tuple:
    """A decoder layer's cross-attention K and V of the encoder output
    ``enc`` (B, enc_seq, d), each (B, Hkv, enc_seq, hd)."""
    B = enc.shape[0]
    kc = L.dense(enc, p.cross.wk, "cross_k")
    vc = L.dense(enc, p.cross.wv, "cross_v")
    return (kc.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2),
            vc.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2))


def _encode(params: Transformer, cfg, frames: torch.Tensor,
            run=lambda fn, h, blk: fn(h, blk)) -> torch.Tensor:
    """The encoder over ``frames`` (B, enc_seq, d), then ``enc_norm``.
    ``run(fn, h, blk)`` runs each block (``forward`` checkpoints it)."""
    enc = frames
    for blk in params.enc_layers:
        enc = run(lambda h, b: _encoder_block(h, b, cfg), enc, blk)
    return L.rms_norm(enc, params.enc_norm, cfg.norm_eps)


def _shared_block(x, p: SharedBlock, cfg, dist: L.Distribution = L.LOCAL, *, positions,
                  kv_cache=None):
    """The hybrid's weight-shared full-attention + MLP block. Returns (x,
    new_kv_cache)."""
    h, new_cache = L.attention_block(
        L.rms_norm(x, p.attn_norm, cfg.norm_eps), p.attn, cfg, dist, causal=True,
        positions=positions, kv_cache=kv_cache)
    x = x + h
    x = x + L.mlp_block(L.rms_norm(x, p.mlp_norm, cfg.norm_eps), p.mlp, cfg, dist)
    return x, new_cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _embed(params: Transformer, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return gathered(params, ("embed",)).embed[tokens]


def _logits(params: Transformer, cfg, x: torch.Tensor) -> torch.Tensor:
    params = gathered(params, ("final_norm", "lm_head"))
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
    """batch: {"tokens": (B, S)} plus the family's extras: vlm {"patches":
    (B, n_patches, d)}, placed ahead of the text; encdec {"frames": (B,
    enc_seq, d)}, the encoder's input. Returns logits (B, S_total,
    padded_vocab) f32 (S_total = n_patches + S for vlm), or the final-norm
    hidden states (B, S_total, d) when ``return_hidden`` (the chunked loss
    computes the head itself). ``remat`` "block" or "full" checkpoints every
    block while gradients are recorded (the recompute gives the same bits);
    "none" keeps every activation. On a mesh the global batch goes in and
    the rank's block comes out (module docstring); ``moe_impl`` "tp" or "ep"
    picks the MoE's parallelism."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat {remat!r} (expected none, block or full)")
    refuse_mesh(cfg, dist)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    rows, pos = block_of(dist, tokens.shape[0], S)
    sp = seq_sharded(dist, S)
    x = _embed(params, cfg, tokens[rows, pos])
    prefix_len = 0
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        prefix_len = cfg.n_patches
    positions = torch.arange(pos.start, pos.start + x.shape[1], device=x.device)
    use_remat = remat != "none" and torch.is_grad_enabled()
    run = lambda fn, h, blk: dispatch.checkpoint(fn, h, blk) if use_remat else fn(h, blk)

    if cfg.family == "encdec":
        enc = _encode(params, cfg, batch["frames"].to(x.dtype), run)

        def dec_body(h, blk):
            return _decoder_block(h, blk, cfg, dist, positions=positions,
                                  enc_out=_cross_kv(enc, blk, cfg))[0]

        for blk in params.dec_layers:
            x = run(dec_body, x, blk)
        if return_hidden:
            return L.rms_norm(x, params.final_norm, cfg.norm_eps)
        return _logits(params, cfg, x)

    def body(h, blk):
        return _decoder_block(h, blk, cfg, dist, positions=positions, prefix_len=prefix_len,
                              moe_impl=moe_impl, seq_sharded=sp)[0]

    def shared(h, blk):
        return _shared_block(h, blk, cfg, dist, positions=positions)[0]

    for i, blk in enumerate(params.layers):
        x = run(body, x, blk)
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            x = run(shared, x, params.shared)
    if return_hidden:
        return L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode_step
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Cache for incremental decoding, the reference's tree: {"len": 0,
    "layers": ...}. Attention layers (dense, MoE) hold float K/V, {"k", "v":
    (n_layers, B, n_kv_heads, max_len, head_dim)} in ``dtype``; SSM layers
    {"conv_x", "conv_B", "conv_C": (n_layers, B, w-1, ·)} in ``dtype`` and
    {"state": (n_layers, B, g, e, p, n)} in f32. A hybrid's ``layers``
    leaves lead with (groups, attn_every) in place of n_layers, and
    ``shared`` holds each group's K/V of the shared block, (groups, B,
    n_kv_heads, max_len, head_dim). An encdec cache adds ``cross``, each
    decoder layer's K/V of the encoder output, {"k", "v": (n_layers, B,
    n_kv_heads, enc_seq, head_dim)} in ``dtype``, which ``prefill`` fills;
    a vlm cache is the dense one. (The int8 cache comes with a later
    slice.)"""
    check_family(cfg)
    dev = resolve_device(device)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache(n):
        shape = (n, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    def ssm_cache(*lead):
        g, e = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
        w, gn = cfg.ssm_conv, cfg.ssm_groups * cfg.ssm_state
        return {"conv_x": zeros(*lead, batch, w - 1, cfg.d_inner),
                "conv_B": zeros(*lead, batch, w - 1, gn),
                "conv_C": zeros(*lead, batch, w - 1, gn),
                "state": zeros(*lead, batch, g, e, cfg.ssm_head_dim, cfg.ssm_state,
                               dt=torch.float32)}

    if cfg.family == "ssm":
        return {"len": 0, "layers": ssm_cache(cfg.n_layers)}
    if cfg.family == "hybrid":
        ng = n_groups(cfg)
        return {"len": 0, "layers": ssm_cache(ng, cfg.attn_every), "shared": attn_cache(ng)}
    cache = {"len": 0, "layers": attn_cache(cfg.n_layers)}
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim)
        cache["cross"] = {"k": zeros(*shape), "v": zeros(*shape)}
    return cache


@torch.inference_mode()
def decode_step(params: Transformer, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, dist: L.Distribution = L.LOCAL, *,
                moe_impl: str = "tp"):
    """One incremental decode step. tokens: (B, 1) int, the cache's rows (on
    a mesh the rank's, ``block_of``).
    Returns (logits (B, 1, V), new_cache); the cache tensors (K/V, conv and
    SSM states) are updated in place and shared with the returned cache.

    ``cache["len"]``, the write cursor, is an int or a 0-d integer tensor on
    the device; with a tensor the step reads no host value, so it can be
    captured in a CUDA graph (``launch.batching``). ``cache["start"]``
    (B,), when present, is the continuous batcher's per-slot lower bound
    of attention (dense, MoE and vlm). An encdec step attends each decoder
    layer's cached cross K/V (``prefill`` fills them)."""
    refuse_mesh(cfg, dist)
    layers = cache["layers"]
    # the batch axis: K/V (n, B, ...); an SSM state (..., B, g, e, p, n)
    rows = layers["state"].shape[-5] if cfg.family in SSM_FAMILIES else layers["k"].shape[1]
    if tokens.shape[0] != rows:
        raise ValueError(f"{tokens.shape[0]} rows of tokens, the cache holds {rows}")
    x = _embed(params, cfg, tokens)
    ln = cache["len"]
    pos = ln + torch.zeros((x.shape[0], 1), dtype=torch.int64, device=x.device)
    start = cache.get("start")
    new_cache = {"len": ln + 1, "layers": layers}
    if cfg.family in SSM_FAMILIES:
        hybrid = cfg.family == "hybrid"
        for i, blk in enumerate(params.layers):
            at = divmod(i, cfg.attn_every) if hybrid else i      # (group, position)
            x, _ = _decoder_block(x, blk, cfg, dist, positions=pos,
                                  kv_cache={k: layers[k][at] for k in SSM.CACHE_KEYS})
            if hybrid and at[1] == cfg.attn_every - 1:
                kv = {"k": cache["shared"]["k"][at[0]], "v": cache["shared"]["v"][at[0]],
                      "len": ln}
                x, _ = _shared_block(x, params.shared, cfg, dist, positions=pos, kv_cache=kv)
        if hybrid:
            new_cache["shared"] = cache["shared"]
        return _logits(params, cfg, x), new_cache
    if cfg.family == "encdec":
        cross = cache["cross"]
        for i, blk in enumerate(params.dec_layers):
            kv = {"k": layers["k"][i], "v": layers["v"][i], "len": ln}
            x, _ = _decoder_block(x, blk, cfg, dist, positions=pos, kv_cache=kv,
                                  enc_out=(cross["k"][i], cross["v"][i]))
        new_cache["cross"] = cross
        return _logits(params, cfg, x), new_cache
    for i, blk in enumerate(params.layers):
        kv = {"k": layers["k"][i], "v": layers["v"][i], "len": ln, "start": start}
        x, _ = _decoder_block(x, blk, cfg, dist, positions=pos, kv_cache=kv,
                              moe_impl=moe_impl)
    if start is not None:
        new_cache["start"] = start
    return _logits(params, cfg, x), new_cache


@torch.inference_mode()
def prefill(params: Transformer, cfg: ModelConfig, batch: dict, cache: dict,
            dist: L.Distribution = L.LOCAL, *, moe_impl: str = "tp"):
    """Fill the cache from a prompt by running decode_step over positions.
    Returns (last logits (B, V), cache). On a mesh the batch is the global
    one, the cache and the logits the rank's rows (``block_of``).

    encdec: the encoder runs once over ``batch["frames"]`` and every decoder
    layer's cross K/V are written into ``cache["cross"]`` in place first.
    vlm: ``batch["patches"]`` is not read (the prompt's text alone fills
    the cache), as in the reference."""
    refuse_mesh(cfg, dist)
    tokens = batch["tokens"]
    tokens = tokens[block_of(dist, tokens.shape[0], 1)[0]]
    if cfg.family == "encdec":
        enc = _encode(params, cfg, batch["frames"])
        for i, blk in enumerate(params.dec_layers):
            kc, vc = _cross_kv(enc, blk, cfg)
            cache["cross"]["k"][i].copy_(kc)
            cache["cross"]["v"][i].copy_(vc)
    last = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, cache, tokens[:, t:t + 1], dist,
                                    moe_impl=moe_impl)
        last = logits[:, 0]
    return last, cache
