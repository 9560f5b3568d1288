"""BLAS-style transparent dispatch (counterpart of ``repro.core.dispatch``,
single device).

Model code never calls ``torch.matmul`` directly; it calls
``gemm(a, b, site="attn_q")``. A ``NumericsPolicy`` installed with
``use_policy`` maps each call-site to a ``GemmConfig`` <format, accumulator,
execution target>, so an unmodified model runs under any numerics.

Modes (the reference's strings):
    native   - plain matmul: inputs rounded onto the format's grid, products
               summed in f32 (``preferred_element_type=f32`` in the
               reference), f32 result.
    simulate - bit-exact <ovf,msb,lsb> FDP in plain PyTorch (core.fdp).
    pallas   - the FDP GEMM kernels: the hand-written CUDA kernels on CUDA
               tensors, their plain versions on CPU tensors.

Every entry point (``gemm``, ``grouped_qk``, ``grouped_av``, ``ragged_gemm``)
is a ``torch.autograd.Function``: differentiating through it dispatches the
two backward GEMMs of the site as sites of their own, ``<site>@bwd.dA`` and
``<site>@bwd.dB``, each looked up under its own config. The policy is the
one captured at the forward call and kept in the autograd context, never
the ambient one at backward time: for CUDA tensors torch runs ``backward``
on its own device thread, where the thread-local policy of ``use_policy``
is not installed.

Every dispatch, forward or backward, in every mode, reports ``(site_key,
cfg, a, b, out)`` to the trace hooks (``set_trace_hook``, ``add_trace_hook``)
when any is installed; with none, the check is one ``is None``. A
``PrecisionPlan`` JSON deploys through ``policy_from_plan``; its non-GEMM
(optimizer-state, collective) assignments ride in ``NumericsPolicy.aux``.

``reduce_axis`` (sharded contractions) and plan autotuning come with later
slices.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Optional, Union

import torch

from .accumulator import SAFE_CHUNK, AccumulatorSpec
from .formats import BF16, FP32, FloatFormat, PositFormat

# Native fp32 must be full fp32, as the reference's f32 dot is. TF32 keeps
# ~10 fraction bits, so it is pinned off here, for every caller in the
# process, before any native matmul or convolution can run.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Structured site identity
# ---------------------------------------------------------------------------
PHASES = ("fwd", "bwd")
OPERANDS = ("", "dA", "dB")


@dataclasses.dataclass(frozen=True)
class GemmSite:
    """Structured identity of one GEMM computation stage: ``name`` is the
    model-level call-site, ``phase`` the autodiff stage ("fwd" | "bwd") and
    ``operand`` which backward GEMM ("dA" | "dB"; empty for forward).
    Canonical keys: "attn_qk", "attn_qk@bwd.dA", "attn_qk@bwd.dB"."""

    name: str
    phase: str = "fwd"
    operand: str = ""

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"bad site phase {self.phase!r}")
        if self.operand not in OPERANDS:
            raise ValueError(f"bad site operand {self.operand!r}")
        if self.phase == "fwd" and self.operand:
            raise ValueError("forward sites carry no operand tag")
        if "@" in self.name or "." in self.name:
            raise ValueError(f"site name {self.name!r} may not contain @ or .")

    @property
    def key(self) -> str:
        if self.phase == "fwd":
            return self.name
        return (f"{self.name}@{self.phase}.{self.operand}"
                if self.operand else f"{self.name}@{self.phase}")

    def bwd(self, operand: str) -> "GemmSite":
        return GemmSite(self.name, "bwd", operand)

    @classmethod
    def parse(cls, site: Union[str, "GemmSite"]) -> "GemmSite":
        if isinstance(site, GemmSite):
            return site
        if "@" not in site:
            return cls(site)
        name, _, rest = site.partition("@")
        phase, _, operand = rest.partition(".")
        return cls(name, phase, operand)


def _parse_pattern(pat: str) -> tuple:
    """Pattern grammar ``NAME[@PHASE[.OPERAND]]``: NAME may end in ``*``;
    PHASE/OPERAND may be ``*``. A pattern with no ``@`` is forward-only."""
    if "@" in pat:
        name, _, rest = pat.partition("@")
        phase, _, op = rest.partition(".")
        return name, phase, (op or "*")
    return pat, "fwd", "*"


def _match_score(pat: str, site: GemmSite) -> Optional[int]:
    """Specificity of a pattern against a site, or None on no match: exact
    name beats prefix wildcard, exact phase beats ``*``, exact operand
    beats ``*``."""
    name, phase, op = _parse_pattern(pat)
    if name == site.name:
        score = 8
    elif name.endswith("*") and site.name.startswith(name[:-1]):
        score = 2
    else:
        return None
    if phase == site.phase:
        score += 4
    elif phase != "*":
        return None
    if op == site.operand:
        score += 1
    elif op != "*":
        return None
    return score


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    fmt: FloatFormat | PositFormat = BF16
    acc: Optional[AccumulatorSpec] = None      # None => native fp32 accumulate
    mode: str = "native"                       # native | simulate | pallas

    def __post_init__(self):
        if self.mode not in ("native", "simulate", "pallas"):
            raise ValueError(self.mode)
        if self.mode != "native" and self.acc is None:
            raise ValueError(f"mode={self.mode} requires an AccumulatorSpec")

    def tag(self) -> str:
        acc = (f"<{self.acc.ovf},{self.acc.msb},{self.acc.lsb}>"
               if self.acc else "fp32acc")
        return f"{self.fmt.name}/{acc}/{self.mode}"


def widen_config(cfg: GemmConfig) -> GemmConfig:
    """The gradient-safe fallback for sites with no explicit bwd assignment:
    fp32 inputs, and for FDP modes the paper's <30,30,-30> accumulator."""
    if cfg.mode == "native":
        return GemmConfig(FP32, None, "native")
    return GemmConfig(FP32, AccumulatorSpec.paper_91bit(), cfg.mode)


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """Call-site -> GemmConfig mapping; ``default`` covers unlisted sites.
    The most specific matching pattern wins; ties go to the earliest
    override (``with_override`` prepends)."""

    default: GemmConfig = GemmConfig()
    overrides: tuple = ()                      # tuple[(pattern, GemmConfig)]
    name: str = "default"
    # Non-GEMM precision assignments keyed by qformat site keys
    # ("opt.m@state", "grad_psum@coll") mapping to qformat.QuantConfig. Kept
    # out of ``overrides``: aux keys are not GemmSites, and GemmConfig
    # consumers never see them.
    aux: tuple = ()                            # tuple[(site_key, QuantConfig)]

    def lookup(self, site: Union[str, GemmSite]) -> GemmConfig:
        s = GemmSite.parse(site)
        best, best_score = None, -1
        for pat, cfg in self.overrides:
            sc = _match_score(pat, s)
            if sc is not None and sc > best_score:
                best, best_score = cfg, sc
        return best if best is not None else self.default

    def aux_lookup(self, site_key: str):
        """QuantConfig for an aux (state/collective) site key, or None when
        the policy leaves that site at its fp32 default."""
        for key, cfg in self.aux:
            if key == site_key:
                return cfg
        return None

    def with_override(self, pattern: str, cfg: GemmConfig) -> "NumericsPolicy":
        return dataclasses.replace(
            self, overrides=((pattern, cfg),) + tuple(self.overrides))

    def with_aux(self, site_key: str, cfg) -> "NumericsPolicy":
        kept = tuple((k, c) for k, c in self.aux if k != site_key)
        return dataclasses.replace(self, aux=((site_key, cfg),) + kept)


MXU_BF16 = NumericsPolicy(GemmConfig(BF16, None, "native"), name="mxu_bf16")
MXU_FP32 = NumericsPolicy(GemmConfig(FP32, None, "native"), name="mxu_fp32")
# The paper's flagship uniform numerics: every site through the bit-exact
# <30,30,-30> FDP.
FDP91 = NumericsPolicy(
    GemmConfig(FP32, AccumulatorSpec(ovf=30, msb=30, lsb=-30), "simulate"),
    name="fdp91_uniform")

_state = threading.local()
_UNSET = object()


def current_policy() -> NumericsPolicy:
    return getattr(_state, "policy", MXU_BF16)


@contextlib.contextmanager
def use_policy(policy: NumericsPolicy):
    """Swap the per-thread numerics; the previous state is restored even
    when the body raises."""
    if not isinstance(policy, NumericsPolicy):
        raise TypeError(f"use_policy expects a NumericsPolicy, got {policy!r}")
    prev = getattr(_state, "policy", _UNSET)
    _state.policy = policy
    try:
        yield policy
    finally:
        if prev is _UNSET:
            del _state.policy
        else:
            _state.policy = prev


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)`` whose recompute runs under
    the policy current here. The recompute happens during backward, on
    autograd's device thread for CUDA tensors, where ``use_policy`` of the
    caller's thread is not installed: without this, a recomputed site would
    dispatch under the default policy and its gradient would no longer
    match its forward."""
    from torch.utils.checkpoint import checkpoint as _checkpoint
    pol = current_policy()

    def run(*a):
        with use_policy(pol):
            return fn(*a)

    return _checkpoint(run, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Site registry: which sites were dispatched, and how often
# ---------------------------------------------------------------------------
_SITE_CALLS: collections.Counter = collections.Counter()
_SITES_LOCK = threading.Lock()


def sites_seen() -> frozenset:
    """All GEMM call-site keys dispatched since the last reset."""
    with _SITES_LOCK:
        return frozenset(_SITE_CALLS)


def site_calls() -> dict:
    """Dispatches per site key since the last reset (every dispatch in an
    FDP mode is one FDP GEMM; in ``pallas`` mode on a CUDA tensor, one
    kernel launch unless the output is empty)."""
    with _SITES_LOCK:
        return dict(_SITE_CALLS)


def reset_sites_seen() -> None:
    with _SITES_LOCK:
        _SITE_CALLS.clear()


def _note_site(key: str) -> None:
    with _SITES_LOCK:
        _SITE_CALLS[key] += 1


# ---------------------------------------------------------------------------
# Trace hooks
# ---------------------------------------------------------------------------
# Every dispatched GEMM reports (site_key, cfg, a, b, out) to the installed
# hooks, forward and backward sites under their own keys, in every mode. The
# hook runs eagerly, after the GEMM, on the thread that dispatched it (for a
# CUDA backward, autograd's device thread). ``_TRACE_HOOK`` is None-checked
# so that the path costs nothing without a hook.
_TRACE_HOOK = None          # composed view over the slots below
_PRIMARY_HOOK = None        # the calibration slot (set_trace_hook)
_EXTRA_HOOKS: list = []     # additive observers (add_trace_hook)


def _recompose_hooks() -> None:
    global _TRACE_HOOK
    hooks = ([_PRIMARY_HOOK] if _PRIMARY_HOOK is not None else []) + list(_EXTRA_HOOKS)
    if not hooks:
        _TRACE_HOOK = None
    elif len(hooks) == 1:
        _TRACE_HOOK = hooks[0]
    else:
        def _fanout(site_key, cfg, a, b, out, _hooks=tuple(hooks)):
            for h in _hooks:
                h(site_key, cfg, a, b, out)
        _TRACE_HOOK = _fanout


def set_trace_hook(hook):
    """Install (or clear, with None) the primary hook; returns the previous
    one so callers can restore it. Hooks added with ``add_trace_hook`` are a
    separate channel and keep firing across set/restore pairs."""
    global _PRIMARY_HOOK
    prev = _PRIMARY_HOOK
    _PRIMARY_HOOK = hook
    _recompose_hooks()
    return prev


def add_trace_hook(hook):
    """Install an additional hook beside the primary slot. Returns a
    zero-argument remover."""
    _EXTRA_HOOKS.append(hook)
    _recompose_hooks()

    def _remove():
        try:
            _EXTRA_HOOKS.remove(hook)
        except ValueError:
            pass
        _recompose_hooks()
    return _remove


def _maybe_trace(site_key, cfg, a, b, out):
    if _TRACE_HOOK is not None:
        _TRACE_HOOK(site_key, cfg, a, b, out)
    return out


# ---------------------------------------------------------------------------
# GemmPlan: cached block-size plans
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Block sizes for one (shape, fmt, spec, backend) problem instance,
    resolved and fitted as in the reference. The CUDA kernel's tile is
    fixed, so dispatch resolves no plan per call and a plan changes no
    launch (``kernels.ops``)."""

    bm: int
    bn: int
    bk: int
    source: str = "heuristic"

    @property
    def tile(self) -> tuple:
        return (self.bm, self.bn, self.bk)

    def fit(self, m: int, n: int, k: int) -> "GemmPlan":
        """Clamp this plan to one problem: blocks stop at the (8-aligned)
        problem dims and bk at the SAFE_CHUNK carry-headroom bound."""
        bm = min(self.bm, _ceil8(m))
        bn = min(self.bn, _ceil8(n))
        bk = min(min(self.bk, SAFE_CHUNK), _ceil8(k))
        if (bm, bn, bk) == (self.bm, self.bn, self.bk):
            return self
        return dataclasses.replace(self, bm=bm, bn=bn, bk=bk)


def _ceil8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


def _heuristic_plan(batch: int, m: int, n: int, k: int) -> GemmPlan:
    """Shape-derived default tile (the reference's table)."""
    bm = min(128, _ceil8(m))
    bn = min(128, _ceil8(n))
    bk = min(1024, min(SAFE_CHUNK, _ceil8(k)))
    return GemmPlan(bm, bn, bk, source="heuristic")


@dataclasses.dataclass(frozen=True)
class PlanCacheStats:
    """Typed snapshot of the plan cache's counters. ``autotuned`` and
    ``persisted_loads`` stay 0 in the port until plan autotuning and the
    schedule zoo are ported."""

    size: int
    hits: int
    misses: int
    autotuned: int
    persisted_loads: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_PLAN_CACHE: dict = {}
_PLAN_OPS = {"hits": 0, "misses": 0, "autotuned": 0, "persisted_loads": 0}
_PLAN_LOCK = threading.Lock()


def plan_gemm(m: int, n: int, k: int, *, fmt, spec: AccumulatorSpec,
              batch: int = 1, backend: str = "cuda") -> GemmPlan:
    """Resolve (and cache) the block-size plan for one GEMM problem, keyed
    by (batch, M, N, K, fmt, spec, backend)."""
    key = (batch, m, n, k, fmt.name, spec, backend)
    with _PLAN_LOCK:
        cached = _PLAN_CACHE.get(key)
        if cached is not None:
            _PLAN_OPS["hits"] += 1
            return cached
        _PLAN_OPS["misses"] += 1
        return _PLAN_CACHE.setdefault(key, _heuristic_plan(batch, m, n, k))


def register_plan(m: int, n: int, k: int, plan: GemmPlan, *, fmt,
                  spec: AccumulatorSpec, batch: int = 1, backend: str = "cuda") -> None:
    """Pin a plan (e.g. from an offline sweep) for a problem signature; it is
    cached with ``source="override"``."""
    key = (batch, m, n, k, fmt.name, spec, backend)
    with _PLAN_LOCK:
        _PLAN_CACHE[key] = dataclasses.replace(plan, source="override")


def plan_cache_stats() -> PlanCacheStats:
    """Counters of the process-global plan cache."""
    with _PLAN_LOCK:
        return PlanCacheStats(size=len(_PLAN_CACHE), **_PLAN_OPS)


def clear_plan_cache() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        _PLAN_OPS.update(dict.fromkeys(_PLAN_OPS, 0))


# ---------------------------------------------------------------------------
# Dispatch core
# ---------------------------------------------------------------------------
def _dispatch(site: GemmSite, cfg: GemmConfig, a: torch.Tensor, b: torch.Tensor,
              *, plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Run one matmul as one site: count the key, execute under the resolved
    config, report to the trace hooks."""
    _note_site(site.key)
    return _maybe_trace(site.key, cfg, a, b, _execute(cfg, a, b, plan=plan))


def _execute(cfg: GemmConfig, a: torch.Tensor, b: torch.Tensor, *,
             plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Run one matmul under a resolved GemmConfig (the mode switch)."""
    if cfg.mode == "native":
        if not isinstance(cfg.fmt, FloatFormat):
            raise ValueError(f"native mode needs a float format, not {cfg.fmt.name}")
        # Round onto the format's grid, then multiply in f32: bf16/fp16
        # products are exact in f32, so this is the reference's
        # preferred_element_type=f32 (torch's bf16 matmul would round the
        # result to bf16 instead).
        return torch.matmul(cfg.fmt.quantize(a), cfg.fmt.quantize(b))

    # FDP modes: float inputs are rounded onto the format's grid first (the
    # paper's format front end); posit carriers are already bit patterns.
    if isinstance(cfg.fmt, FloatFormat):
        a, b = cfg.fmt.quantize(a), cfg.fmt.quantize(b)

    if cfg.mode == "simulate":
        from . import fdp
        f = lambda x, y: fdp.fdp_gemm(x, y, cfg.acc, cfg.fmt)
        return _batched_apply(f, a, b)

    from repro_torch.kernels import ops as kops
    return kops.fdp_gemm_nd(a, b, spec=cfg.acc, fmt=cfg.fmt, plan=plan)


def _batched_apply(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply a 2-D (M,K)x(K,N) function over broadcast leading batch dims,
    one batch element at a time."""
    from repro_torch.kernels.ops import matmul_batching
    f3d = lambda x, y: torch.stack([f(xi, yi) for xi, yi in zip(x, y)])
    return matmul_batching(f, f3d)(a, b)


def _unbroadcast(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum a cotangent down to a (numpy-broadcast) primal operand shape."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    extra = x.ndim - len(shape)
    if extra:
        x = x.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (xs, ps) in enumerate(zip(x.shape, shape))
                 if ps == 1 and xs != 1)
    if axes:
        x = x.sum(dim=axes, keepdim=True)
    return x


class _Gemm(torch.autograd.Function):
    """``gemm`` with its two backward GEMMs dispatched as sites
    (``_gemm_vjp_bwd`` of the reference)."""

    @staticmethod
    def forward(ctx, a, b, site: GemmSite, pol: NumericsPolicy, plan):
        ctx.site, ctx.pol = site, pol
        ctx.save_for_backward(a, b)
        return _dispatch(site, pol.lookup(site), a, b, plan=plan)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        site, pol = ctx.site, ctx.pol
        # torch.matmul 1-D promotion: lift to 2-D, compute, drop the unit
        # dims. The N axis goes in before the M axis so the vector-dot case,
        # where g is 0-d, lifts cleanly to (1, 1).
        a2 = a[None, :] if a.ndim == 1 else a
        b2 = b[:, None] if b.ndim == 1 else b
        g2 = g
        if b.ndim == 1:
            g2 = g2[..., None]
        if a.ndim == 1:
            g2 = g2[..., None, :]
        da = db = None
        if ctx.needs_input_grad[0]:
            da_site = site.bwd("dA")
            da = _dispatch(da_site, pol.lookup(da_site), g2, b2.transpose(-1, -2))
            da = _unbroadcast(da, a2.shape).reshape(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db_site = site.bwd("dB")
            db_cfg = pol.lookup(db_site)
            if b2.ndim == 2:
                # weight gradient: one flattened Aᵀ·G GEMM over all leading
                # dims (the reference's contraction order: batch-major rows)
                af = a2.reshape(-1, a2.shape[-1])
                gf = g2.reshape(-1, g2.shape[-1])
                db = _dispatch(db_site, db_cfg, af.transpose(0, 1), gf)
            else:
                db = _dispatch(db_site, db_cfg, a2.transpose(-1, -2), g2)
                db = _unbroadcast(db, b2.shape)
            db = db.reshape(b.shape).to(b.dtype)
        return da, db, None, None, None


def gemm(a: torch.Tensor, b: torch.Tensor, *, site: Union[str, GemmSite] = "generic",
         policy: Optional[NumericsPolicy] = None,
         plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Policy-dispatched matmul with ``torch.matmul`` semantics; f32 out.
    Differentiating through it dispatches ``<site>@bwd.dA`` (G·Bᵀ) and
    ``<site>@bwd.dB`` (Aᵀ·G) under the policy captured here. ``plan`` is
    checked as in the reference (pallas mode only) and changes no launch."""
    pol = policy or current_policy()
    return _Gemm.apply(a, b, GemmSite.parse(site), pol, plan)


# -- grouped attention einsums ----------------------------------------------
def _grouped_qk_execute(site: GemmSite, cfg: GemmConfig, q: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """q (B,Kh,G,Sq,hd) x k (B,Kh,Sk,hd) -> (B,Kh,G,Sq,Sk). FDP modes run
    one flattened 4-D dispatch."""
    B, Kh, G, Sq, hd = q.shape
    if cfg.mode != "native":
        out = _dispatch(site, cfg, q.reshape(B, Kh, G * Sq, hd), k.transpose(-1, -2))
        return out.reshape(B, Kh, G, Sq, k.shape[2])
    _note_site(site.key)
    out = torch.einsum("bkgqd,bksd->bkgqs", cfg.fmt.quantize(q), cfg.fmt.quantize(k))
    if _TRACE_HOOK is not None:
        # reported in matmul shape, as the FDP modes dispatch it
        _TRACE_HOOK(site.key, cfg, q.reshape(B, Kh, G * Sq, hd), k.transpose(-1, -2),
                    out.reshape(B, Kh, G * Sq, -1))
    return out


def _grouped_av_execute(site: GemmSite, cfg: GemmConfig, p: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """p (B,Kh,G,Sq,Sk) x v (B,Kh,Sk,hd) -> (B,Kh,G,Sq,hd)."""
    B, Kh, G, Sq, Sk = p.shape
    if cfg.mode != "native":
        out = _dispatch(site, cfg, p.reshape(B, Kh, G * Sq, Sk), v)
        return out.reshape(B, Kh, G, Sq, v.shape[-1])
    _note_site(site.key)
    out = torch.einsum("bkgqs,bksd->bkgqd", cfg.fmt.quantize(p), cfg.fmt.quantize(v))
    if _TRACE_HOOK is not None:
        _TRACE_HOOK(site.key, cfg, p.reshape(B, Kh, G * Sq, Sk), v,
                    out.reshape(B, Kh, G * Sq, -1))
    return out


def _grouped_dright(site: GemmSite, cfg: GemmConfig, lhs: torch.Tensor,
                    rhs: torch.Tensor) -> torch.Tensor:
    """The shared dK/dV backward contraction ``bkgqx,bkgqy->bkxy`` (sum over
    heads-in-group and query positions): dK = dright(g, q), dV = dright(p,
    g)."""
    B, Kh, G, Sq, X = lhs.shape
    flat = lambda: (lhs.reshape(B, Kh, G * Sq, X).transpose(-1, -2),
                    rhs.reshape(B, Kh, G * Sq, -1))
    if cfg.mode != "native":
        return _dispatch(site, cfg, *flat())
    _note_site(site.key)
    out = torch.einsum("bkgqx,bkgqy->bkxy", cfg.fmt.quantize(lhs), cfg.fmt.quantize(rhs))
    if _TRACE_HOOK is not None:
        _TRACE_HOOK(site.key, cfg, *flat(), out)
    return out


class _GroupedQK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, site: GemmSite, pol: NumericsPolicy):
        ctx.site, ctx.pol = site, pol
        ctx.save_for_backward(q, k)
        return _grouped_qk_execute(site, pol.lookup(site), q, k)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        dq_site, dk_site = ctx.site.bwd("dA"), ctx.site.bwd("dB")
        dq = dk = None
        if ctx.needs_input_grad[0]:
            # dQ = einsum("bkgqs,bksd->bkgqd", g, k): the grouped_av contraction
            dq = _grouped_av_execute(dq_site, ctx.pol.lookup(dq_site), g, k).to(q.dtype)
        if ctx.needs_input_grad[1]:
            # dK = einsum("bkgqs,bkgqd->bksd", g, q)
            dk = _grouped_dright(dk_site, ctx.pol.lookup(dk_site), g, q).to(k.dtype)
        return dq, dk, None, None


class _GroupedAV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, v, site: GemmSite, pol: NumericsPolicy):
        ctx.site, ctx.pol = site, pol
        ctx.save_for_backward(p, v)
        return _grouped_av_execute(site, pol.lookup(site), p, v)

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        dp_site, dv_site = ctx.site.bwd("dA"), ctx.site.bwd("dB")
        dp = dv = None
        if ctx.needs_input_grad[0]:
            # dP = einsum("bkgqd,bksd->bkgqs", g, v): the grouped_qk contraction
            dp = _grouped_qk_execute(dp_site, ctx.pol.lookup(dp_site), g, v).to(p.dtype)
        if ctx.needs_input_grad[1]:
            # dV = einsum("bkgqs,bkgqd->bksd", p, g)
            dv = _grouped_dright(dv_site, ctx.pol.lookup(dv_site), p, g).to(v.dtype)
        return dp, dv, None, None


def grouped_qk(q: torch.Tensor, k: torch.Tensor, *,
               site: Union[str, GemmSite] = "attn_qk",
               policy: Optional[NumericsPolicy] = None) -> torch.Tensor:
    """GQA score einsum q (B,Kh,G,Sq,hd) x k (B,Kh,Sk,hd) -> (B,Kh,G,Sq,Sk).
    Backward dispatches ``<site>@bwd.dA`` (dQ) / ``<site>@bwd.dB`` (dK)."""
    pol = policy or current_policy()
    return _GroupedQK.apply(q, k, GemmSite.parse(site), pol)


def grouped_av(p: torch.Tensor, v: torch.Tensor, *,
               site: Union[str, GemmSite] = "attn_av",
               policy: Optional[NumericsPolicy] = None) -> torch.Tensor:
    """GQA value einsum p (B,Kh,G,Sq,Sk) x v (B,Kh,Sk,hd) -> (B,Kh,G,Sq,hd).
    Backward dispatches ``<site>@bwd.dA`` (dP) / ``<site>@bwd.dB`` (dV)."""
    pol = policy or current_policy()
    return _GroupedAV.apply(p, v, GemmSite.parse(site), pol)


# -- grouped (expert) GEMM --------------------------------------------------
def _segment_ids(group_sizes: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Segment id per sorted row from the group-size prefix sums; rows beyond
    sum(group_sizes) get id E (no group). Computed on the device."""
    bounds = torch.cumsum(group_sizes, dim=0)
    rows = torch.arange(n_rows, device=group_sizes.device)
    return (rows[:, None] >= bounds[None, :]).sum(dim=1)


def _fit_ragged(plan: GemmPlan, axis: str, n_rows: int, n_groups: int) -> GemmPlan:
    """Clamp the plan's token-axis block to the mean segment size (8-aligned),
    as the reference does for its tile walk. The CUDA kernel has no token
    block (one block row per token), so no launch reads the result."""
    block = min(getattr(plan, axis), _ceil8(max(1, n_rows // max(1, n_groups))))
    if block == getattr(plan, axis):
        return plan
    return dataclasses.replace(plan, **{axis: block})


def _ragged_execute(site: GemmSite, cfg: GemmConfig, x: torch.Tensor,
                    w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The mode switch of ``ragged_gemm``.

    native   - every group's matmul over all T rows, then row t takes its
               group's row (T x E work, like the reference's simulate path;
               ``jax.lax.ragged_dot`` has no torch counterpart). Nothing is
               read on the host, and rows past the total are 0.0.
    simulate - ``core.fdp.fdp_ragged_gemm``: one FDP GEMM per group on its
               rows (reads the group sizes on the host; the plain oracle).
    pallas   - the sorted-segment kernel (its plain version on the CPU).

    The trace hooks see one (T, d) x (E*d, f) call: the rows and the whole
    flattened expert stack, as the reference reports it."""
    _note_site(site.key)
    out = _ragged_mode_switch(cfg, x, w, group_sizes)
    if _TRACE_HOOK is not None:
        E, d, f = w.shape
        _TRACE_HOOK(site.key, cfg, x, w.reshape(E * d, f), out)
    return out


def _ragged_mode_switch(cfg: GemmConfig, x: torch.Tensor, w: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    if cfg.mode == "native":
        if not isinstance(cfg.fmt, FloatFormat):
            raise ValueError(f"native mode needs a float format, not {cfg.fmt.name}")
        E = w.shape[0]
        per_expert = torch.matmul(cfg.fmt.quantize(x), cfg.fmt.quantize(w))  # (E,T,f)
        seg = _segment_ids(group_sizes, x.shape[0])
        rows = torch.arange(x.shape[0], device=x.device)
        out = per_expert[seg.clamp(max=E - 1), rows]
        return torch.where((seg < E)[:, None], out, 0.0)
    if isinstance(cfg.fmt, FloatFormat):
        x, w = cfg.fmt.quantize(x), cfg.fmt.quantize(w)
    if cfg.mode == "simulate":
        from . import fdp
        return fdp.fdp_ragged_gemm(x, w, group_sizes, cfg.acc, cfg.fmt)
    from repro_torch.kernels import ops as kops
    return kops.fdp_ragged_gemm(x, w, group_sizes, spec=cfg.acc, fmt=cfg.fmt)


def _ragged_dw(site: GemmSite, cfg: GemmConfig, x: torch.Tensor, g: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``ragged_gemm``, ``dW[e] = X_eᵀ · G_e`` (E, d,
    f), under one resolved config.

    native   - every expert's masked Aᵀ·G over all T rows (the reference's
               T x E path), selected by segment id on the device.
    simulate - ``core.fdp.fdp_ragged_dw``: one FDP GEMM per group on its
               rows (the same bits as the masked pass).
    pallas   - the sorted-segment weight-gradient kernel (its plain version
               on the CPU).

    The trace hooks see one (d, T) x (T, f) call and the (E*d, f) output."""
    _note_site(site.key)
    out = _ragged_dw_mode_switch(cfg, x, g, group_sizes)
    if _TRACE_HOOK is not None:
        E, d, f = out.shape
        _TRACE_HOOK(site.key, cfg, x.transpose(0, 1), g, out.reshape(E * d, f))
    return out


def _ragged_dw_mode_switch(cfg: GemmConfig, x: torch.Tensor, g: torch.Tensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
    E = group_sizes.shape[0]
    if cfg.mode == "native":
        if not isinstance(cfg.fmt, FloatFormat):
            raise ValueError(f"native mode needs a float format, not {cfg.fmt.name}")
        seg = _segment_ids(group_sizes, x.shape[0])
        masks = seg[None, :] == torch.arange(E, device=x.device)[:, None]   # (E, T)
        xm = torch.where(masks[:, :, None], cfg.fmt.quantize(x), 0.0)      # (E, T, d)
        return torch.matmul(xm.transpose(-1, -2), cfg.fmt.quantize(g))
    if isinstance(cfg.fmt, FloatFormat):
        x, g = cfg.fmt.quantize(x), cfg.fmt.quantize(g)
    if cfg.mode == "simulate":
        from . import fdp
        return fdp.fdp_ragged_dw(x, g, group_sizes, cfg.acc, cfg.fmt)
    from repro_torch.kernels import ops as kops
    return kops.fdp_ragged_dw(x, g, group_sizes, num_groups=E, spec=cfg.acc,
                              fmt=cfg.fmt)


class _Ragged(torch.autograd.Function):
    """``ragged_gemm`` with its backward sites (``_ragged_vjp_bwd`` of the
    reference): dX is the same ragged contraction against the transposed
    per-expert weights, dW the sorted-segment weight gradient; the integer
    group sizes get no gradient."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, site: GemmSite, pol: NumericsPolicy):
        ctx.site, ctx.pol = site, pol
        ctx.save_for_backward(x, w, group_sizes)
        return _ragged_execute(site, pol.lookup(site), x, w, group_sizes)

    @staticmethod
    def backward(ctx, g):
        x, w, group_sizes = ctx.saved_tensors
        dx_site, dw_site = ctx.site.bwd("dA"), ctx.site.bwd("dB")
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _ragged_execute(dx_site, ctx.pol.lookup(dx_site), g,
                                 w.transpose(-1, -2), group_sizes).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _ragged_dw(dw_site, ctx.pol.lookup(dw_site), x, g,
                            group_sizes).to(w.dtype)
        return dx, dw, None, None, None


def ragged_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                site: Union[str, GemmSite] = "moe_expert",
                policy: Optional[NumericsPolicy] = None) -> torch.Tensor:
    """Grouped (expert) GEMM: ``x (T, d)`` rows sorted by group, ``w (E, d,
    f)`` per-group weights, ``group_sizes (E,)`` rows per group. Output ``(T,
    f)`` f32: row t contracts against its group's weight matrix, rows beyond
    ``sum(group_sizes)`` are 0.0. Backward dispatches ``<site>@bwd.dA`` (dX)
    and ``<site>@bwd.dB`` (dW)."""
    pol = policy or current_policy()
    return _Ragged.apply(x, w, group_sizes, GemmSite.parse(site), pol)


def policy_from_plan(path) -> NumericsPolicy:
    """Load a serialized ``PrecisionPlan`` and return the NumericsPolicy it
    deploys (the ``--precision-plan`` entry point)."""
    from repro_torch.numerics import load_plan    # deferred: numerics imports us
    return load_plan(path).to_policy()


def quantize_inputs(x: torch.Tensor, site: Union[str, GemmSite] = "generic",
                    policy: Optional[NumericsPolicy] = None) -> torch.Tensor:
    """Round an activation or weight onto the grid of the format its site's
    config names, keeping ``x``'s dtype (posit values come back as floats)."""
    pol = policy or current_policy()
    fmt = pol.lookup(site).fmt
    if isinstance(fmt, PositFormat):
        return fmt.to_float(fmt.from_float(x)).to(x.dtype)
    return x.to(fmt.torch_dtype).to(x.dtype)
