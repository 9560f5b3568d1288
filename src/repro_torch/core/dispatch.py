"""BLAS-style transparent dispatch (counterpart of ``repro.core.dispatch``).

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
when any is installed, except in the recompute of a ``checkpoint``ed region;
with none, the check is one ``is None``. A
``PrecisionPlan`` JSON deploys through ``policy_from_plan``; its non-GEMM
(optimizer-state, collective) assignments ride in ``NumericsPolicy.aux``.

In ``pallas`` mode every dense FDP dispatch resolves one ``GemmPlan``
(``plan_gemm``, cached per problem) for the launch the kernel makes; a
plan measured on the card (``plan_gemm(autotune=True)``, or preloaded from
the schedule zoo of ``core.schedules``) names that launch.

``gemm(..., reduce_axis=...)`` is a K-sharded contraction over the axes of
the mesh bound by ``parallel.axes.use_mesh``: each rank contracts its local
K-shard and the cross-rank reduction runs under the site's config (module
``repro_torch.parallel.collectives``; ``_execute_reduce``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
import time
from typing import Optional, Union

import torch

from repro_torch.device import capturing
from repro_torch.parallel.axes import psum
from repro_torch.obs.registry import default_registry as _obs_registry

from .accumulator import SAFE_CHUNK, AccumulatorSpec
from .fdp import segment_ids as _segment_ids
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
    runs = [0]

    def run(*a):
        # every run after the first is the backward's recompute: its
        # dispatches reach no trace hook, as the reference's callbacks do
        # not fire in a rematerialized forward
        runs[0] += 1
        prev = getattr(_state, "recomputing", False)
        _state.recomputing = runs[0] > 1
        try:
            with use_policy(pol):
                return fn(*a)
        finally:
            _state.recomputing = prev

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
# CUDA backward, autograd's device thread); not during a checkpointed
# region's recompute. ``_TRACE_HOOK`` is None-checked first, so that the
# path costs nothing without a hook.
#
# A hook that a CUDA-graph capture may record sets ``capturable = True`` and
# offers two context managers, which ``launch.batching.capture`` enters:
# ``warmup()`` around each eager warm-up call of the body (the hook records
# nothing there) and ``capture()``, entered before the graph's capture
# begins and left after it ends, yielding a record whose ``seal()`` the
# capture calls inside the graph, after the body. Every other hook (the
# calibration slot's too) refuses a capture: it would run at capture only,
# never at replay.
_TRACE_HOOK = None          # composed view over the slots below
_PRIMARY_HOOK = None        # the calibration slot (set_trace_hook)
_EXTRA_HOOKS: list = []     # additive observers (add_trace_hook)


def _recompose_hooks() -> None:
    global _TRACE_HOOK
    hooks = trace_hooks()
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


def trace_hooks() -> tuple:
    """The installed hooks, the primary slot first."""
    return ((_PRIMARY_HOOK,) if _PRIMARY_HOOK is not None else ()) + tuple(_EXTRA_HOOKS)


def _active_hook():
    """The trace hook a dispatch reports to: None without one, and in a
    checkpointed region's recompute."""
    if _TRACE_HOOK is None or getattr(_state, "recomputing", False):
        return None
    return _TRACE_HOOK


def _maybe_trace(site_key, cfg, a, b, out):
    hook = _active_hook()
    if hook is not None:
        hook(site_key, cfg, a, b, out)
    return out


# ---------------------------------------------------------------------------
# GemmPlan: cached block-size plans
# ---------------------------------------------------------------------------
# The fields of a launch of the dense kernel (``kernels.fdp_gemm.DenseLaunch``)
# that a plan may name, in order.
LAUNCH_FIELDS = ("lc", "tm", "tn", "tx", "ty", "ks", "bks")


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Block sizes for one (shape, fmt, spec, backend) problem instance, and
    optionally the launch of the dense kernel that runs it.

    ``source`` records provenance: "heuristic" (shape-derived table),
    "measured" (autotuned on this host), "persisted" (installed from a
    schedule zoo) or "override" (``register_plan``). ``launch`` holds the
    seven ``LAUNCH_FIELDS`` of a ``kernels.fdp_gemm.DenseLaunch`` when the
    plan names one (measured plans do); ``bm, bn, bk`` are then its block
    tile. A plan without a launch leaves the layout to the kernel's cost
    model (``dense_launch``); one with a launch is launched as named, or
    refused where it is not a layout of the call."""

    bm: int
    bn: int
    bk: int
    source: str = "heuristic"
    launch: Optional[tuple] = None

    def __post_init__(self):
        if self.launch is None:
            return
        if len(self.launch) != len(LAUNCH_FIELDS):
            raise ValueError(f"a launch has the fields {LAUNCH_FIELDS}, got {self.launch}")
        lc, tm, tn, tx, ty, ks, bks = self.launch
        if self.tile != (ty * tm, tx * tn, ks * bks):
            raise ValueError(f"blocks {self.tile} are not the tile of launch {self.launch}")

    @property
    def tile(self) -> tuple:
        return (self.bm, self.bn, self.bk)

    def fit(self, m: int, n: int, k: int) -> "GemmPlan":
        """Clamp this plan to one problem: blocks stop at the (8-aligned)
        problem dims and bk at the SAFE_CHUNK carry-headroom bound. A plan
        that names a launch is returned as it is: its blocks are the
        launch's tile, which the kernel checks against the call."""
        if self.launch is not None:
            return self
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
    """Typed snapshot of the plan cache's counters, a view over the obs
    registry (``repro_plan_cache_ops_total{op=...}`` and
    ``repro_plan_cache_size``, the reference's names). ``autotuned`` counts
    plans measured by ``plan_gemm(autotune=True)``; ``persisted_loads``
    counts entries installed from a schedule zoo, so a warm process serving
    out of a checked-in zoo shows ``misses == 0`` and ``persisted_loads >
    0``."""

    size: int
    hits: int
    misses: int
    autotuned: int
    persisted_loads: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_PLAN_CACHE: dict = {}
_PLAN_LOCK = threading.Lock()

# The plan-cache counters live in the obs registry (stdlib-only at this
# layer): one source for plan_cache_stats() and the Prometheus/JSON
# exposition.
_PLAN_OPS = _obs_registry().counter(
    "repro_plan_cache_ops_total",
    "GemmPlan cache operations (hit/miss/autotuned/persisted_load)", ("op",))
_PLAN_SIZE = _obs_registry().gauge(
    "repro_plan_cache_size", "resident GemmPlan cache entries")


def plan_gemm(m: int, n: int, k: int, *, fmt, spec: AccumulatorSpec,
              batch: int = 1, backend: str = "cuda", autotune: bool = False,
              report: Optional[list] = None) -> GemmPlan:
    """Resolve (and cache) the plan for one GEMM problem, keyed by (batch,
    M, N, K, fmt, spec, backend); ``backend`` is the device type of the
    operands ("cuda" or "cpu").

    The default is the heuristic table (no launch named, no kernel run).
    ``autotune`` measures the dense kernel's candidate launches on the
    backend's device (``_measure_plan``) and caches the winner, upgrading a
    cached ``heuristic`` entry in place; ``measured``, ``persisted`` and
    ``override`` entries are never re-measured. It is refused while the
    current stream is being captured into a CUDA graph. ``report``, when
    given, receives one record a candidate timed."""
    if autotune and capturing():
        raise RuntimeError("plan_gemm(autotune=True) runs kernels; it is refused "
                           "while a CUDA graph is being captured")
    key = (batch, m, n, k, fmt.name, spec, backend)
    with _PLAN_LOCK:
        cached = _PLAN_CACHE.get(key)
        if cached is not None and (not autotune or cached.source != "heuristic"):
            _PLAN_OPS.inc(op="hits")
            return cached
        if not autotune:
            _PLAN_OPS.inc(op="misses")
            plan = _PLAN_CACHE.setdefault(key, _heuristic_plan(batch, m, n, k))
            _PLAN_SIZE.set(len(_PLAN_CACHE))
            return plan
    plan = _measure_plan(m, n, k, fmt=fmt, spec=spec, batch=batch, backend=backend,
                         report=report)
    _PLAN_OPS.inc(op="autotuned")
    _PLAN_OPS.inc(op="misses")
    with _PLAN_LOCK:
        _PLAN_CACHE[key] = plan
        _PLAN_SIZE.set(len(_PLAN_CACHE))
    return plan


def register_plan(m: int, n: int, k: int, plan: GemmPlan, *, fmt,
                  spec: AccumulatorSpec, batch: int = 1, backend: str = "cuda") -> None:
    """Pin a plan (e.g. from an offline sweep) for a problem signature; it is
    cached with ``source="override"``."""
    key = (batch, m, n, k, fmt.name, spec, backend)
    with _PLAN_LOCK:
        _PLAN_CACHE[key] = dataclasses.replace(plan, source="override")
        _PLAN_SIZE.set(len(_PLAN_CACHE))


def plan_cache_stats() -> PlanCacheStats:
    """Counters of the process-global plan cache: a view over the obs
    registry's plan-cache families."""
    with _PLAN_LOCK:
        size = len(_PLAN_CACHE)
    return PlanCacheStats(size=size, **{op: int(_PLAN_OPS.value(op=op)) for op in (
        "hits", "misses", "autotuned", "persisted_loads")})


def clear_plan_cache() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        _PLAN_SIZE.set(0)
    _PLAN_OPS.clear()


# The autotuner. Candidates: the AUTOTUNE_TOP launches of the dense kernel
# that its cost model ranks first for the call (the reference weighs 7
# tiles and its heuristic), the model's own pick among them. Timing
# discipline (the reference's): best of MEASURE_REPS samples, each looping
# the call until it has run MEASURE_MIN_SECONDS.
AUTOTUNE_TOP = 8
MEASURE_REPS = 3
MEASURE_MIN_SECONDS = 1e-3


def _time_candidate(fn, *, reps: int = MEASURE_REPS,
                    min_seconds: float = MEASURE_MIN_SECONDS, sync=None) -> float:
    """Best-of-``reps`` seconds a call of ``fn`` (already warm), each sample
    looping the call until it clears ``min_seconds``. ``sync`` waits for the
    device (``torch.cuda.synchronize`` on a card): the clock is read around
    it."""
    sync = sync or (lambda: None)
    t0 = time.perf_counter()
    fn()
    sync()
    dt = max(time.perf_counter() - t0, 1e-9)
    inner = max(1, math.ceil(min_seconds / dt))
    best = dt if inner == 1 else float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def _measure_plan(m: int, n: int, k: int, *, fmt, spec: AccumulatorSpec, batch: int = 1,
                  backend: str = "cuda", report: Optional[list] = None) -> GemmPlan:
    """Time the dense kernel's candidate launches (``AUTOTUNE_TOP`` of
    ``kernels.fdp_gemm.dense_candidates``) for a (batch, m, k) @ (batch, k,
    n) launch on operands from a seeded generator on the ``backend``'s
    device, and return the fastest as a ``measured`` plan naming its launch.
    Every candidate's output must equal the model pick's (``torch.equal``),
    and a refused launch raises. On CPU tensors every candidate runs the
    plain version: the logic is exercised there, not the pick."""
    from repro_torch.kernels import fdp_gemm as K
    dev = torch.device(backend)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((batch, m, k), generator=gen, device=dev)
    b = torch.randn((batch, k, n), generator=gen, device=dev)
    if isinstance(fmt, PositFormat):
        a, b = fmt.from_float(a), fmt.from_float(b)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None
    cands = K.dense_candidates(spec.num_limbs, batch, m, n, k, K.device_sms(dev),
                               AUTOTUNE_TOP)
    want, best = None, None
    for rank, lay in enumerate(cands):
        fn = lambda lay=lay: K.fdp_gemm(a, b, spec=spec, fmt=fmt, launch=lay)
        out = fn()                                    # build, warm
        if want is None:
            want = out
        elif not torch.equal(out, want):
            raise RuntimeError(f"launch {lay} disagrees with the model pick {cands[0]} "
                               f"at ({batch}, {m}, {n}, {k})")
        seconds = _time_candidate(fn, sync=sync)
        if report is not None:
            report.append({"rank": rank, "launch": lay, "seconds": seconds})
        if best is None or seconds < best[1]:
            best = (lay, seconds)
    lay = best[0]
    return GemmPlan(*lay.tile, source="measured", launch=dataclasses.astuple(lay))


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

    # pallas: without a plan, the kernel wrapper resolves one (plan_gemm) for
    # the launch it makes, the counterpart of the reference's
    # _plan_for_operands here
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


# -- sharded contraction: cross-rank reduction under the site's spec --------
def _execute_reduce(cfg: GemmConfig, a: torch.Tensor, b: torch.Tensor,
                    axis_name) -> torch.Tensor:
    """One K-sharded matmul: the local partial contraction and the
    cross-rank reduction over ``axis_name``, under a resolved GemmConfig.

    native mode all-reduces the local f32 partials (a float sum, whose
    order depends on the mesh, like any stock all-reduce). The FDP modes
    reduce the accumulator register: local limbs from
    ``fdp.fdp_gemm_limbs``, the exact integer ``fdp_psum`` across ranks,
    then the one read-out rounding, so the sharded result is the unsharded
    ``fdp_gemm``'s bits for any mesh or order. pallas mode reduces through
    the same plain limb path, as the reference's does: the kernel returns
    floats, not registers (a limb-output mode of the dense kernel waits in
    ROADMAP, *Kernel work after the port*)."""
    if cfg.mode == "native":
        return psum(_execute(cfg, a, b), axis_name)

    if a.ndim != 2 or b.ndim != 2:
        raise NotImplementedError(
            "sharded FDP contraction (reduce_axis=...) supports 2-D operands")
    if isinstance(cfg.fmt, FloatFormat):
        a, b = cfg.fmt.quantize(a), cfg.fmt.quantize(b)
    from repro_torch.parallel.collectives import fdp_psum
    from . import accumulator as acc_mod
    from . import fdp
    limbs = fdp.fdp_gemm_limbs(a, b, cfg.acc, cfg.fmt)
    return acc_mod.to_float(cfg.acc, fdp_psum(limbs, axis_name, cfg.acc))


def _dispatch_reduce(site: GemmSite, cfg: GemmConfig, a: torch.Tensor,
                     b: torch.Tensor, axis_name) -> torch.Tensor:
    _note_site(site.key)
    return _maybe_trace(site.key, cfg, a, b, _execute_reduce(cfg, a, b, axis_name))


class _Gemm(torch.autograd.Function):
    """``gemm`` with its two backward GEMMs dispatched as sites
    (``_gemm_vjp_bwd`` of the reference). A K-sharded forward (``reduce_axis``
    set) needs no collective in the backward: with the cotangent g the same
    on every rank (the reduced output is), dA = G·B_locᵀ and dB = A_locᵀ·G
    are already the local shards of the full gradients, so both dispatch as
    local sites."""

    @staticmethod
    def forward(ctx, a, b, site: GemmSite, pol: NumericsPolicy, plan, reduce_axis):
        ctx.site, ctx.pol = site, pol
        ctx.save_for_backward(a, b)
        if reduce_axis is not None:
            return _dispatch_reduce(site, pol.lookup(site), a, b, reduce_axis)
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
        return da, db, None, None, None, None


def gemm(a: torch.Tensor, b: torch.Tensor, *, site: Union[str, GemmSite] = "generic",
         policy: Optional[NumericsPolicy] = None,
         plan: Optional[GemmPlan] = None, reduce_axis=None) -> torch.Tensor:
    """Policy-dispatched matmul with ``torch.matmul`` semantics; f32 out.
    Differentiating through it dispatches ``<site>@bwd.dA`` (G·Bᵀ) and
    ``<site>@bwd.dB`` (Aᵀ·G) under the policy captured here. ``plan``
    (pallas mode only) replaces the plan the call would resolve: its launch,
    if it names one, runs the dense kernel.

    ``reduce_axis`` (a mesh axis name or a tuple of them) makes the
    contraction sharding-aware: under ``parallel.axes.use_mesh``, with K
    sharded over those axes, each rank contracts its local K-shard and the
    reduction runs under the site's config: FDP sites through the exact
    limb-summed ``fdp_psum`` (the unsharded bits), native sites through a
    float psum. The output is the same on every rank of ``reduce_axis``."""
    pol = policy or current_policy()
    return _Gemm.apply(a, b, GemmSite.parse(site), pol, plan, reduce_axis)


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
    hook = _active_hook()
    if hook is not None:
        # reported in matmul shape, as the FDP modes dispatch it
        hook(site.key, cfg, q.reshape(B, Kh, G * Sq, hd), k.transpose(-1, -2),
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
    hook = _active_hook()
    if hook is not None:
        hook(site.key, cfg, p.reshape(B, Kh, G * Sq, Sk), v, out.reshape(B, Kh, G * Sq, -1))
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
    hook = _active_hook()
    if hook is not None:
        hook(site.key, cfg, *flat(), out)
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
def _fit_ragged(plan: GemmPlan, axis: str, n_rows: int, n_groups: int) -> GemmPlan:
    """Clamp the plan's token-axis block to the mean segment size (8-aligned),
    as the reference does for its tile walk, and drop a launch the plan may
    name (one measured for the dense kernel). No launch reads the result:
    the sorted-segment kernels' layouts come from
    ``kernels.fdp_gemm.ragged_launch``/``ragged_dw_launch``, which size their
    tiles from the same mean (T / E) rather than from a plan."""
    block = min(getattr(plan, axis), _ceil8(max(1, n_rows // max(1, n_groups))))
    if block == getattr(plan, axis) and plan.launch is None:
        return plan
    return dataclasses.replace(plan, launch=None, **{axis: block})


def _ragged_execute(site: GemmSite, cfg: GemmConfig, x: torch.Tensor,
                    w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The mode switch of ``ragged_gemm``.

    native   - every group's matmul over all T rows, then row t takes its
               group's row (T x E work, like the reference's simulate path;
               ``jax.lax.ragged_dot`` has no torch counterpart). Nothing is
               read on the host, and rows past the total are 0.0.
    simulate - ``core.fdp.fdp_ragged_gemm``: one FDP GEMM per group on its
               rows (reads the group sizes on the host; the plain oracle),
               or, while a CUDA graph is being captured, every group over
               all T rows selected on the device (the same bits).
    pallas   - the sorted-segment kernel (its plain version on the CPU).

    The trace hooks see one (T, d) x (E*d, f) call: the rows and the whole
    flattened expert stack, as the reference reports it."""
    _note_site(site.key)
    out = _ragged_mode_switch(cfg, x, w, group_sizes)
    hook = _active_hook()
    if hook is not None:
        E, d, f = w.shape
        hook(site.key, cfg, x, w.reshape(E * d, f), out)
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
    E, d, f = w.shape
    plan = plan_gemm(x.shape[0], f, d, fmt=cfg.fmt, spec=cfg.acc, backend=x.device.type)
    return kops.fdp_ragged_gemm(x, w, group_sizes, spec=cfg.acc, fmt=cfg.fmt,
                                plan=_fit_ragged(plan, "bm", x.shape[0], E))


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
    hook = _active_hook()
    if hook is not None:
        E, d, f = out.shape
        hook(site.key, cfg, x.transpose(0, 1), g, out.reshape(E * d, f))
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
    d, f = x.shape[1], g.shape[1]
    plan = plan_gemm(d, f, x.shape[0], fmt=cfg.fmt, spec=cfg.acc, backend=x.device.type)
    return kops.fdp_ragged_dw(x, g, group_sizes, num_groups=E, spec=cfg.acc,
                              fmt=cfg.fmt, plan=_fit_ragged(plan, "bk", x.shape[0], E))


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
