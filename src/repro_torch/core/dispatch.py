"""BLAS-style transparent dispatch (counterpart of ``repro.core.dispatch``,
forward serving subset).

Model code never calls ``torch.matmul`` directly; it calls
``gemm(a, b, site="attn_q")``. A ``NumericsPolicy`` installed with
``use_policy`` maps each call-site to a ``GemmConfig`` <format, accumulator,
execution target>, so an unmodified model runs under any numerics.

Modes (the reference's strings):
    native   - plain matmul: inputs rounded onto the format's grid, products
               summed in f32 (``preferred_element_type=f32`` in the
               reference), f32 result.
    simulate - bit-exact <ovf,msb,lsb> FDP in plain PyTorch (core.fdp).
    pallas   - the FDP GEMM kernel: the hand-written CUDA kernel on a CUDA
               tensor, its plain version on a CPU tensor.

Backward sites (``@bwd.dA``/``@bwd.dB`` through autograd), ``ragged_gemm``,
``reduce_axis``, plan autotuning and trace hooks come with later slices.
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

    def lookup(self, site: Union[str, GemmSite]) -> GemmConfig:
        s = GemmSite.parse(site)
        best, best_score = None, -1
        for pat, cfg in self.overrides:
            sc = _match_score(pat, s)
            if sc is not None and sc > best_score:
                best, best_score = cfg, sc
        return best if best is not None else self.default

    def with_override(self, pattern: str, cfg: GemmConfig) -> "NumericsPolicy":
        return dataclasses.replace(
            self, overrides=((pattern, cfg),) + tuple(self.overrides))


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


_PLAN_CACHE: dict = {}
_PLAN_OPS = {"hits": 0, "misses": 0}
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


def plan_cache_stats() -> dict:
    """{"size", "hits", "misses"} of the process-global plan cache."""
    with _PLAN_LOCK:
        return {"size": len(_PLAN_CACHE), **_PLAN_OPS}


def clear_plan_cache() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        _PLAN_OPS.update(hits=0, misses=0)


# ---------------------------------------------------------------------------
# Dispatch core
# ---------------------------------------------------------------------------
def _dispatch(site: GemmSite, cfg: GemmConfig, a: torch.Tensor, b: torch.Tensor,
              *, plan: Optional[GemmPlan] = None) -> torch.Tensor:
    _note_site(site.key)
    return _execute(cfg, a, b, plan=plan)


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


def gemm(a: torch.Tensor, b: torch.Tensor, *, site: Union[str, GemmSite] = "generic",
         policy: Optional[NumericsPolicy] = None,
         plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Policy-dispatched matmul with ``torch.matmul`` semantics; f32 out.
    ``plan`` is checked as in the reference (pallas mode only) and changes
    no launch."""
    pol = policy or current_policy()
    s = GemmSite.parse(site)
    return _dispatch(s, pol.lookup(s), a, b, plan=plan)


# -- grouped attention einsums ----------------------------------------------
def grouped_qk(q: torch.Tensor, k: torch.Tensor, *,
               site: Union[str, GemmSite] = "attn_qk",
               policy: Optional[NumericsPolicy] = None) -> torch.Tensor:
    """GQA score einsum q (B,Kh,G,Sq,hd) x k (B,Kh,Sk,hd) -> (B,Kh,G,Sq,Sk).
    FDP modes run one flattened 4-D dispatch."""
    pol = policy or current_policy()
    s = GemmSite.parse(site)
    cfg = pol.lookup(s)
    if cfg.mode == "native":
        _note_site(s.key)
        return torch.einsum("bkgqd,bksd->bkgqs", cfg.fmt.quantize(q),
                            cfg.fmt.quantize(k))
    B, Kh, G, Sq, hd = q.shape
    out = _dispatch(s, cfg, q.reshape(B, Kh, G * Sq, hd), k.transpose(-1, -2))
    return out.reshape(B, Kh, G, Sq, k.shape[2])


def grouped_av(p: torch.Tensor, v: torch.Tensor, *,
               site: Union[str, GemmSite] = "attn_av",
               policy: Optional[NumericsPolicy] = None) -> torch.Tensor:
    """GQA value einsum p (B,Kh,G,Sq,Sk) x v (B,Kh,Sk,hd) -> (B,Kh,G,Sq,hd)."""
    pol = policy or current_policy()
    s = GemmSite.parse(site)
    cfg = pol.lookup(s)
    if cfg.mode == "native":
        _note_site(s.key)
        return torch.einsum("bkgqs,bksd->bkgqd", cfg.fmt.quantize(p),
                            cfg.fmt.quantize(v))
    B, Kh, G, Sq, Sk = p.shape
    out = _dispatch(s, cfg, p.reshape(B, Kh, G * Sq, Sk), v)
    return out.reshape(B, Kh, G, Sq, v.shape[-1])
