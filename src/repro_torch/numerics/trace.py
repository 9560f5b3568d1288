"""Calibration tracing: record what every GEMM call-site actually computes
(counterpart of ``repro.numerics.trace``).

``calibrate()`` installs the primary trace hook of
``repro_torch.core.dispatch``, so every dispatched GEMM, forward or
backward, in every mode, reports its operands and output into a host-side
``CalibrationTrace``. The hook runs eagerly after the GEMM, on the thread
that dispatched it (autograd's device thread for a CUDA backward). Each
call-site accumulates a ``SiteProfile``:

  * shapes and call counts,
  * exponent ranges of both operands (floor(log2 |x|) of the extreme
    magnitudes), which drive candidate pruning and the exact-oracle sizing,
  * a condition proxy (``cancellation_bits``: how far the output magnitude
    sits below the no-cancellation upper bound),
  * total MAC count (the energy model's cycle denominator),
  * one captured operand sample per site, on which the search evaluates
    candidate numerics against a bit-exact FDP oracle.

A backward under ``calibrate()`` records every gradient GEMM under its own
phase-qualified key (``attn_qk@bwd.dA``). A checkpointed region's recompute
(``dispatch.checkpoint``) is not reported, as the reference's debug
callbacks do not fire in a rematerialized forward.

A saved trace is the reference's JSON document: either package loads what
the other saved.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import json
import math
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dispatch, qformat
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.formats import PositFormat

TRACE_VERSION = 1
# The document kind is the reference's, so traces interchange.
TRACE_KIND = "repro.numerics.CalibrationTrace"


def config_fingerprint(obj) -> str:
    """Stable short hash of a config-like object (dataclass, dict, anything
    JSON-renderable). Saved into trace documents so a trace calibrated under
    one (model config, calibration shape) is never silently reused for
    another."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    blob = json.dumps(obj, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _encode_array(x: Optional[np.ndarray]) -> Optional[dict]:
    if x is None:
        return None
    x = np.ascontiguousarray(x)
    return {"dtype": str(x.dtype), "shape": list(x.shape),
            "data": base64.b64encode(x.tobytes()).decode("ascii")}


def _decode_array(d: Optional[dict]) -> Optional[np.ndarray]:
    if d is None:
        return None
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def _enc_float(v: float):
    """JSON-safe float: math.inf (the min-tracker's initial value) -> None."""
    return None if not math.isfinite(v) else v


def _dec_float(v, default: float) -> float:
    return default if v is None else float(v)


def _floor_log2(v: float) -> Optional[int]:
    """floor(log2(v)) for a positive finite float, else None."""
    if not (v > 0.0) or not math.isfinite(v):
        return None
    return math.frexp(v)[1] - 1


@dataclasses.dataclass
class SiteProfile:
    """Aggregated calibration statistics for one GEMM call-site."""

    site: str
    calls: int = 0
    macs: int = 0
    max_k: int = 0
    shapes: dict = dataclasses.field(default_factory=dict)
    cfg_tags: set = dataclasses.field(default_factory=set)
    # operand/output magnitude extremes (absolute values, f32 domain)
    a_abs_max: float = 0.0
    a_abs_min_nz: float = math.inf
    b_abs_max: float = 0.0
    b_abs_min_nz: float = math.inf
    out_abs_max: float = 0.0
    out_abs_min_nz: float = math.inf
    # first captured operand sample (rows x K, K x cols) for candidate eval
    sample_a: Optional[np.ndarray] = None
    sample_b: Optional[np.ndarray] = None

    # -- exponent ranges ---------------------------------------------------
    @property
    def a_exp_max(self):
        return _floor_log2(self.a_abs_max)

    @property
    def a_exp_min(self):
        return _floor_log2(self.a_abs_min_nz)

    @property
    def b_exp_max(self):
        return _floor_log2(self.b_abs_max)

    @property
    def b_exp_min(self):
        return _floor_log2(self.b_abs_min_nz)

    @property
    def prod_exp_max(self) -> int:
        """Upper bound on floor(log2 |a_i * b_j|) over observed operands."""
        ea, eb = self.a_exp_max, self.b_exp_max
        if ea is None or eb is None:
            return 0
        return ea + eb + 1                      # |a||b| < 2^(ea+1) * 2^(eb+1)

    @property
    def sum_growth_bits(self) -> int:
        """ceil(log2 K): how many extra magnitude bits a K-term sum can add."""
        return max(1, math.ceil(math.log2(max(self.max_k, 2))))

    @property
    def msb_required(self) -> int:
        """Smallest accumulator msb that cannot overflow on the observed
        operand range (product bound + K-term sum growth)."""
        return self.prod_exp_max + self.sum_growth_bits + 1

    @property
    def cancellation_bits(self) -> float:
        """Condition proxy: log2(no-cancellation output bound / observed
        |out|). ~0 for benign sums; large when the site cancels heavily and
        therefore needs lsb depth to keep correct bits."""
        if self.out_abs_max <= 0.0:
            return 0.0
        bound = self.a_abs_max * self.b_abs_max * max(self.max_k, 1)
        if bound <= 0.0:
            return 0.0
        return max(0.0, math.log2(bound / self.out_abs_max))

    def lsb_exact(self, precision: int = 24) -> int:
        """lsb at (below) which every observed product is captured exactly:
        the smallest product magnitude minus its 2p fraction bits."""
        ea = self.a_exp_min if self.a_exp_min is not None else -126
        eb = self.b_exp_min if self.b_exp_min is not None else -126
        return ea + eb - 2 * precision

    def exact_spec(self, precision: int = 24) -> AccumulatorSpec:
        """A ⟨ovf,msb,lsb⟩ accumulator that is bit-exact and overflow-free on
        this site's observed operand range: the per-site FDP oracle, sized
        by the trace rather than the format's worst case."""
        return AccumulatorSpec(ovf=self.sum_growth_bits + 2,
                               msb=self.prod_exp_max + 1,
                               lsb=self.lsb_exact(precision) - 2)

    @property
    def sample(self):
        if self.sample_a is None or self.sample_b is None:
            return None
        return self.sample_a, self.sample_b

    def to_dict(self) -> dict:
        """JSON-able summary (samples excluded)."""
        return {
            "site": self.site, "calls": self.calls, "macs": self.macs,
            "max_k": self.max_k,
            "shapes": {"x".join(map(str, k)): v
                       for k, v in sorted(self.shapes.items())},
            "cfg_tags": sorted(self.cfg_tags),
            "a_exp": [self.a_exp_min, self.a_exp_max],
            "b_exp": [self.b_exp_min, self.b_exp_max],
            "cancellation_bits": round(self.cancellation_bits, 2),
            "msb_required": self.msb_required,
        }

    def to_full_dict(self) -> dict:
        """Lossless serialization (everything ``_record`` accumulates,
        including the operand samples): the persistence format behind
        ``CalibrationTrace.save``. ``to_dict`` stays the human summary."""
        return {
            "site": self.site, "calls": self.calls, "macs": self.macs,
            "max_k": self.max_k,
            "shapes": [[list(k), v] for k, v in sorted(self.shapes.items())],
            "cfg_tags": sorted(self.cfg_tags),
            "a_abs_max": self.a_abs_max,
            "a_abs_min_nz": _enc_float(self.a_abs_min_nz),
            "b_abs_max": self.b_abs_max,
            "b_abs_min_nz": _enc_float(self.b_abs_min_nz),
            "out_abs_max": self.out_abs_max,
            "out_abs_min_nz": _enc_float(self.out_abs_min_nz),
            "sample_a": _encode_array(self.sample_a),
            "sample_b": _encode_array(self.sample_b),
        }

    @classmethod
    def from_full_dict(cls, d: dict) -> "SiteProfile":
        return cls(
            site=d["site"], calls=int(d["calls"]), macs=int(d["macs"]),
            max_k=int(d["max_k"]),
            shapes={tuple(k): int(v) for k, v in d["shapes"]},
            cfg_tags=set(d.get("cfg_tags", ())),
            a_abs_max=float(d["a_abs_max"]),
            a_abs_min_nz=_dec_float(d["a_abs_min_nz"], math.inf),
            b_abs_max=float(d["b_abs_max"]),
            b_abs_min_nz=_dec_float(d["b_abs_min_nz"], math.inf),
            out_abs_max=float(d["out_abs_max"]),
            out_abs_min_nz=_dec_float(d["out_abs_min_nz"], math.inf),
            sample_a=_decode_array(d.get("sample_a")),
            sample_b=_decode_array(d.get("sample_b")),
        )

    def describe(self) -> str:
        return (f"{self.site:14s} calls={self.calls:<5d} "
                f"macs={self.macs:.2e} K<={self.max_k} "
                f"a_exp=[{self.a_exp_min},{self.a_exp_max}] "
                f"b_exp=[{self.b_exp_min},{self.b_exp_max}] "
                f"cancel={self.cancellation_bits:.1f}b "
                f"msb_req={self.msb_required}")


def _leaves(values) -> list:
    """The array leaves of a value tree (dicts in sorted key order, as
    ``jax.tree.leaves`` orders them; lists and tuples in order; None is an
    empty subtree), each as a flat host float32 array."""
    if values is None:
        return []
    if isinstance(values, dict):
        return [x for k in sorted(values) for x in _leaves(values[k])]
    if isinstance(values, (list, tuple)):
        return [x for v in values for x in _leaves(v)]
    if isinstance(values, torch.Tensor):
        values = values.detach().to(torch.float32).cpu().numpy()
    return [np.asarray(values, np.float32).reshape(-1)]


class CalibrationTrace:
    """Thread-safe registry of ``SiteProfile``s filled by the dispatch hook."""

    def __init__(self):
        self._lock = threading.Lock()
        self._profiles: dict[str, SiteProfile] = {}
        self.fingerprint: Optional[str] = None     # set by load()/callers
        self.meta: dict = {}

    # -- recording (called by the dispatch hook) ---------------------------
    def _record(self, site, batch, m, n, k, tag, keep_sample,
                a_max, a_min, b_max, b_min, o_max, o_min,
                sample_a, sample_b):
        # Every value arrives materialized on the host (the hook's one copy)
        # BEFORE the lock is taken, as in the reference: a device sync under
        # the lock could wait on work that needs the lock.
        mins = {"a_abs_min_nz": a_min, "b_abs_min_nz": b_min,
                "out_abs_min_nz": o_min}
        with self._lock:
            p = self._profiles.setdefault(site, SiteProfile(site))
            p.calls += 1
            p.macs += batch * m * n * k
            p.max_k = max(p.max_k, k)
            key = (batch, m, n, k)
            p.shapes[key] = p.shapes.get(key, 0) + 1
            p.cfg_tags.add(tag)
            p.a_abs_max = max(p.a_abs_max, a_max)
            p.b_abs_max = max(p.b_abs_max, b_max)
            p.out_abs_max = max(p.out_abs_max, o_max)
            for attr, v in mins.items():
                if math.isfinite(v):
                    setattr(p, attr, min(getattr(p, attr), v))
            if keep_sample and p.sample_a is None:
                p.sample_a = sample_a
                p.sample_b = sample_b

    def record_aux(self, site, values, *, sample_max: int = 4096) -> None:
        """Profile a non-GEMM precision site (``opt.m@state``,
        ``grad_psum@coll``) from a host-side pass over its value tree
        (dicts, lists and tuples of tensors or arrays).

        The same ``SiteProfile`` container is reused with the value-stream
        reading: the a_* magnitude extremes hold the *values'* dynamic range
        (which prunes the quant-candidate bit grid exactly as operand
        exponents prune accumulator widths), ``macs`` counts *elements* (the
        bytes denominator), and ``sample_a`` carries a 1-D evenly-strided
        subsample the search round-trips through candidate formats.
        ``sample_b`` stays None: aux sites have one value stream.
        """
        site = getattr(site, "key", site)        # StateSite/CollectiveSite
        if qformat.site_kind(site) == "gemm":
            raise ValueError(f"record_aux got GEMM-keyed site {site!r}; aux "
                             "sites end in '@state' or '@coll'")
        leaves = _leaves(values)
        flat = (np.concatenate(leaves) if leaves
                else np.zeros((0,), np.float32))
        a = np.abs(flat)
        nz = a[a > 0]
        amax = float(a.max()) if a.size else 0.0
        amin = float(nz.min()) if nz.size else math.inf
        stride = max(1, flat.size // sample_max)
        sample = flat[::stride][:sample_max].copy()
        with self._lock:
            p = self._profiles.setdefault(site, SiteProfile(site))
            p.calls += 1
            p.macs += flat.size
            p.max_k = max(p.max_k, 1)
            p.a_abs_max = max(p.a_abs_max, amax)
            p.out_abs_max = max(p.out_abs_max, amax)
            if math.isfinite(amin):
                p.a_abs_min_nz = min(p.a_abs_min_nz, amin)
                p.out_abs_min_nz = min(p.out_abs_min_nz, amin)
            if p.sample_a is None:
                p.sample_a = sample

    # -- queries -----------------------------------------------------------
    def sites(self, phase: Optional[str] = None) -> list[str]:
        """All traced site keys, optionally restricted to one phase
        ("fwd" returns plain names, "bwd" the ``@bwd.*`` keys; aux
        state/collective sites only appear in the unfiltered listing)."""
        with self._lock:
            keys = sorted(self._profiles)
        if phase is None:
            return keys
        return [k for k in keys if qformat.site_kind(k) == "gemm"
                and dispatch.GemmSite.parse(k).phase == phase]

    def aux_sites(self) -> list[str]:
        with self._lock:
            return sorted(k for k in self._profiles
                          if qformat.site_kind(k) != "gemm")

    def has_sample(self, site: str) -> bool:
        with self._lock:
            p = self._profiles.get(site)
            return p is not None and p.sample_a is not None

    def profile(self, site: str) -> SiteProfile:
        with self._lock:
            return self._profiles[site]

    def profiles(self) -> dict[str, SiteProfile]:
        with self._lock:
            return dict(self._profiles)

    def total_macs(self) -> int:
        with self._lock:
            return sum(p.macs for p in self._profiles.values())

    def summary(self) -> str:
        return "\n".join(p.describe()
                         for _, p in sorted(self.profiles().items()))

    def to_dict(self) -> dict:
        return {s: p.to_dict() for s, p in self.profiles().items()}

    # -- persistence -------------------------------------------------------
    # Calibration runs real forwards of the target model; a saved trace,
    # samples included, lets the search iterate without recalibrating until
    # the config fingerprint changes.
    def save(self, path, *, fingerprint: Optional[str] = None,
             meta: Optional[dict] = None) -> None:
        if fingerprint is not None:
            # a freshly-calibrated trace becomes fingerprinted the moment it
            # is persisted, so searches from the live trace and from a later
            # reload record identical provenance
            self.fingerprint = fingerprint
        if meta is not None:
            self.meta = dict(meta)
        doc = {
            "version": TRACE_VERSION,
            "kind": TRACE_KIND,
            # omitted arguments fall back to the trace's own provenance, so
            # load -> save round-trips never strip fingerprint/meta
            "fingerprint": self.fingerprint,
            "meta": dict(self.meta),
            "profiles": [p.to_full_dict()
                         for _, p in sorted(self.profiles().items())],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path, *,
             expect_fingerprint: Optional[str] = None) -> "CalibrationTrace":
        """Load a saved trace. Rejects documents of the wrong kind, a newer
        schema version, or (when ``expect_fingerprint`` is given) a trace
        calibrated under a different config fingerprint."""
        with open(path) as f:
            doc = json.load(f)
        if doc.get("kind") != TRACE_KIND or "profiles" not in doc:
            raise ValueError(
                f"{path}: not a CalibrationTrace document "
                f"(kind={doc.get('kind')!r})")
        version = int(doc.get("version", 0))
        if version > TRACE_VERSION:
            raise ValueError(
                f"{path}: trace schema version {version} is newer than this "
                f"library's {TRACE_VERSION}; refusing to guess its semantics")
        if expect_fingerprint is not None and \
                doc.get("fingerprint") != expect_fingerprint:
            raise ValueError(
                f"{path}: trace fingerprint {doc.get('fingerprint')!r} does "
                f"not match the expected config fingerprint "
                f"{expect_fingerprint!r}: recalibrate (the model config or "
                f"calibration shape changed since this trace was saved)")
        trace = cls()
        trace.fingerprint = doc.get("fingerprint")
        trace.meta = dict(doc.get("meta", {}))
        for pd in doc["profiles"]:
            p = SiteProfile.from_full_dict(pd)
            trace._profiles[p.site] = p
        return trace


def load_trace(path, *, expect_fingerprint: Optional[str] = None
               ) -> CalibrationTrace:
    """Module-level convenience mirror of ``CalibrationTrace.load``."""
    return CalibrationTrace.load(path, expect_fingerprint=expect_fingerprint)


# ---------------------------------------------------------------------------
# Calibration envelope: the runtime-checkable boundary of a plan's claims
# ---------------------------------------------------------------------------
ENVELOPE_VERSION = 1


def _fmt_emax(fmt) -> int:
    """Max representable exponent of a storage format: the overflow
    capacity a *native* (accumulator-less) site actually has."""
    e = getattr(fmt, "emax", None)
    if e is not None:
        return int(e)
    nbits, es = getattr(fmt, "nbits", None), getattr(fmt, "es", 0)
    if nbits is not None:                       # posit maxpos = 2^((n-2)*2^es)
        return (int(nbits) - 2) * (1 << int(es))
    return 127


def cfg_capacity(cfg) -> tuple:
    """(msb, lsb) magnitude capacity of a site's deployed datapath: the
    fixed-point accumulator's bounds when one is configured (beyond msb a
    wrap-mode Kulisch register silently wraps), else the format's exponent
    reach with no lsb floor."""
    acc = getattr(cfg, "acc", None)
    if acc is not None:
        return int(acc.msb), int(acc.lsb)
    return _fmt_emax(cfg.fmt), None


def build_envelope(trace: CalibrationTrace, plan_or_policy) -> dict:
    """The calibration envelope a deployed plan's claims hold within: per
    GEMM site, the traced operand exponent ranges and call count (the soft
    boundary) and the deployed ⟨msb,lsb⟩ capacity (the hard boundary:
    exceeding msb wraps the accumulator). Stored in
    ``PrecisionPlan.meta["envelope"]``."""
    policy = (plan_or_policy.to_policy()
              if hasattr(plan_or_policy, "to_policy") else plan_or_policy)
    sites = {}
    for site, p in sorted(trace.profiles().items()):
        if qformat.site_kind(site) != "gemm":
            continue
        cfg = policy.lookup(site)
        msb_cap, lsb_cap = cfg_capacity(cfg)
        sites[site] = {
            "a_exp": [p.a_exp_min, p.a_exp_max],
            "b_exp": [p.b_exp_min, p.b_exp_max],
            "out_exp": [_floor_log2(p.out_abs_min_nz),
                        _floor_log2(p.out_abs_max)],
            "msb": msb_cap,
            "lsb": lsb_cap,
            "msb_traced": p.msb_required,
            "lsb_exact": p.lsb_exact(cfg.fmt.precision),
            "calls": p.calls,
            "max_k": p.max_k,
        }
    meta = trace.meta or {}
    tokens = None
    if meta.get("batch") and meta.get("seq"):
        tokens = int(meta["batch"]) * int(meta["seq"])
    return {"version": ENVELOPE_VERSION,
            "trace_fingerprint": trace.fingerprint,
            "traced_tokens": tokens,
            "sites": sites}


def _as_float(fmt, x: torch.Tensor) -> torch.Tensor:
    """Stats domain: posit carriers decode to their float values."""
    if isinstance(fmt, PositFormat):
        return fmt.to_float(x)
    return x.to(torch.float32)


def _make_hook(trace: CalibrationTrace, sample_rows: int, sample_cols: int):
    def hook(site, cfg, a, b, out):
        if a.ndim < 2 or b.ndim < 2:       # 1-D promotions: skip (not model
            return                          # call-sites; stats would be moot)
        m, k = a.shape[-2], a.shape[-1]
        n = b.shape[-1]
        batch = math.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))

        with torch.no_grad():
            af = _as_float(cfg.fmt, a)
            bf = _as_float(cfg.fmt, b)
            of = out.to(torch.float32)

            def absmin_nz(ax):
                return torch.where(ax > 0, ax, math.inf).min()

            aa, ab, ao = af.abs(), bf.abs(), of.abs()
            parts = [torch.stack([aa.max(), absmin_nz(aa), ab.max(), absmin_nz(ab),
                                  ao.max(), absmin_nz(ao)])]
            # one operand sample per site, until the site has one: flattened
            # rows of a, the first batch element's (K, cols) block of b
            keep = not trace.has_sample(site)
            if keep:
                rows = min(sample_rows, math.prod(af.shape[:-1]))
                cols = min(sample_cols, n)
                sa = af.reshape(-1, k)[:rows]
                sb = bf.reshape(-1, k, n)[0][:, :cols]
                parts += [sa.reshape(-1), sb.reshape(-1)]
            # one device-to-host copy a call: the six reductions, and the
            # sample while the site has none
            host = torch.cat(parts).cpu().numpy()
        stats = [float(v) for v in host[:6]]
        sample_a = sample_b = None
        if keep:
            sample_a = host[6:6 + sa.numel()].reshape(tuple(sa.shape)).copy()
            sample_b = host[6 + sa.numel():].reshape(tuple(sb.shape)).copy()
        trace._record(site, batch, m, n, k, cfg.tag(), keep, *stats,
                      sample_a, sample_b)

    return hook


@contextlib.contextmanager
def calibrate(trace: Optional[CalibrationTrace] = None, *,
              sample_rows: int = 16, sample_cols: int = 16):
    """Calibration mode: while active, every dispatched GEMM records its
    per-site statistics into the yielded ``CalibrationTrace``. The previous
    primary trace hook is restored on exit, also when the body raises.
    Hooks added with ``dispatch.add_trace_hook`` keep firing beside it. Not
    re-entrant across threads (the hook is process-global)."""
    trace = trace if trace is not None else CalibrationTrace()
    prev = dispatch.set_trace_hook(_make_hook(trace, sample_rows, sample_cols))
    try:
        yield trace
    finally:
        dispatch.set_trace_hook(prev)
