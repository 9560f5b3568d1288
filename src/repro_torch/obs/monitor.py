"""repro_torch.obs.monitor — live calibration-envelope monitoring per GEMM
site (counterpart of ``repro.obs.monitor``).

Every guarantee a deployed ``PrecisionPlan`` makes (validated correct bits,
overflow-free accumulation, modeled energy) was established offline against
a calibration trace. This module makes those claims checkable at run time: a
monitor installs through the dispatch trace-hook seam
(``dispatch.add_trace_hook``, beside a concurrent ``calibrate()``) and, per
GEMM site,

  * accumulates live operand exponent ranges and MAC counts,
  * counts overflow events — accumulator wrap risk (the live msb requirement
    exceeding the deployed ⟨ovf,msb,lsb⟩ capacity) and non-finite outputs,
  * tracks a cancellation proxy (live product bound vs observed |out|),

then compares the fold against the plan's recorded calibration envelope
(``meta["envelope"]``) to classify each site:

  ``inside``     live traffic within the traced operand ranges with msb
                 headroom beyond the margin — every offline claim stands;
  ``near-edge``  live exponents beyond the traced range (plus grace bits) or
                 msb headroom within the margin;
  ``violated``   an overflow event fired or the live msb requirement exceeds
                 the deployed accumulator capacity. A pluggable alert sink
                 makes this a loud, attributed event.

Device cost: the hook reads nothing back to the host. Per dispatched GEMM it
computes the reference's device scalars (|a| max, |b| max, |out| max, and
the nonzero |a| and |b| min only where the site's envelope has an ``lsb``;
all-finite is read from |out| max, through which a NaN or an infinity
propagates), four kernels a dispatch on a float site, and queues them
with the call's static shape. The queue is folded on the
host, by the reference's ``_record``, in one device-to-host copy: whenever a
reader asks (``status``, ``statuses``, ``worst_status``,
``overflow_events``, ``snapshot``), when the queue reaches ``FOLD_AT``
entries, and at ``uninstall``/``__exit__`` (the reference's
``jax.effects_barrier()``). A hook runs at dispatch on the host, so it sees
no CUDA-graph replay: a monitored engine runs eager steps (``graph=False``),
and a capture refuses while a hook is installed.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from repro_torch.core import dispatch
from repro_torch.numerics.trace import _as_float, cfg_capacity
from repro_torch.obs import registry as _registry

ENVELOPE_VERSION = 1

# EnvelopeStatus values (strings, so snapshots/JSON read naturally; the
# registry gauge uses the code below)
INSIDE = "inside"
NEAR_EDGE = "near-edge"
VIOLATED = "violated"
UNMONITORED = "no-envelope"

STATUS_CODE = {UNMONITORED: -1, INSIDE: 0, NEAR_EDGE: 1, VIOLATED: 2}

# queued dispatches past which the hook folds by itself (one copy)
FOLD_AT = 4096


def _floor_log2(v: float) -> Optional[int]:
    if not (v > 0.0) or not math.isfinite(v):
        return None
    return math.frexp(v)[1] - 1


class SiteStats:
    """Host-side fold of one site's live traffic."""

    __slots__ = ("site", "calls", "macs", "max_k", "a_exp_min", "a_exp_max",
                 "b_exp_min", "b_exp_max", "out_exp_max", "cancel_bits_max",
                 "wrap_events", "nonfinite_events", "msb_capacity")

    def __init__(self, site: str):
        self.site = site
        self.calls = 0
        self.macs = 0
        self.max_k = 0
        self.a_exp_min: Optional[int] = None
        self.a_exp_max: Optional[int] = None
        self.b_exp_min: Optional[int] = None
        self.b_exp_max: Optional[int] = None
        self.out_exp_max: Optional[int] = None
        self.cancel_bits_max = 0.0
        self.wrap_events = 0
        self.nonfinite_events = 0
        self.msb_capacity: Optional[int] = None

    @property
    def prod_exp_max(self) -> Optional[int]:
        if self.a_exp_max is None or self.b_exp_max is None:
            return None
        return self.a_exp_max + self.b_exp_max + 1

    @property
    def msb_required(self) -> Optional[int]:
        """Live analogue of ``SiteProfile.msb_required``: the accumulator msb
        this traffic needs to be provably overflow-free."""
        p = self.prod_exp_max
        if p is None:
            return None
        growth = max(1, math.ceil(math.log2(max(self.max_k, 2))))
        return p + growth + 1

    def to_dict(self) -> dict:
        return {"calls": self.calls, "macs": self.macs, "max_k": self.max_k,
                "a_exp": [self.a_exp_min, self.a_exp_max],
                "b_exp": [self.b_exp_min, self.b_exp_max],
                "out_exp_max": self.out_exp_max,
                "msb_required": self.msb_required,
                "msb_capacity": self.msb_capacity,
                "cancellation_bits": round(self.cancel_bits_max, 2),
                "wrap_events": self.wrap_events,
                "nonfinite_events": self.nonfinite_events}


def _exp_outside(lo, hi, env_range, grace: int, check_lo: bool) -> bool:
    """True when a live exponent range leaves the traced one by more than
    ``grace`` bits. The high side always counts (the overflow direction);
    the low side only on fixed-point sites (``check_lo``: a finite lsb,
    where tiny operands risk quantizing to zero)."""
    if not env_range:
        return False
    elo, ehi = env_range
    if hi is not None and ehi is not None and hi > ehi + grace:
        return True
    if check_lo and lo is not None and elo is not None and lo < elo - grace:
        return True
    return False


def _batch(sa: tuple, sb: tuple) -> int:
    """Elements of the broadcast of two batch shapes (``torch.broadcast_shapes``
    costs tens of microseconds a call; the GEMM has already checked them)."""
    d = len(sa) - len(sb)
    sa, sb = (1,) * -d + tuple(sa), (1,) * d + tuple(sb)
    return math.prod(y if x == 1 else x for x, y in zip(sa, sb))


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| in one reduction (NaN propagates, as in the reference's
    ``jnp.max``), so a non-finite output shows in its |out| max."""
    return torch.linalg.vector_norm(x, ord=math.inf, dtype=torch.float32)


def _absmin_nz(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax > 0, ax, math.inf).min()


class NumericsMonitor:
    """Per-site live monitor + envelope comparator.

    ``envelope`` is a plan's ``meta["envelope"]`` document (or any dict of
    the same shape); sites absent from it report ``no-envelope``.
    ``margin_bits`` is the near-edge headroom threshold against accumulator
    capacity; ``exp_grace`` the tolerated excursion (in exponent bits) beyond
    the traced operand ranges before a site leaves ``inside``.

    Use as a context manager, or ``install()``/``uninstall()`` for
    long-running servers. Monitors and a concurrent ``calibrate()``
    co-exist: installation goes through ``dispatch.add_trace_hook``.
    ``folds`` counts the device-to-host copies the monitor made.
    """

    def __init__(self, envelope: Optional[dict] = None, *,
                 registry: Optional[_registry.Registry] = None,
                 margin_bits: int = 2, exp_grace: int = 2, alert_sink=None):
        self._lock = threading.Lock()
        self._fold_lock = threading.RLock()
        self._stats: dict = {}
        self._alerted: dict = {}
        self._queue: list = []
        self.folds = 0
        self.envelope = dict((envelope or {}).get("sites", envelope or {}))
        self.margin_bits = margin_bits
        self.exp_grace = exp_grace
        self.alert_sinks = [alert_sink] if alert_sink else []
        self._remove = None
        reg = registry or _registry.default_registry()
        self.registry = reg
        self._calls = reg.counter(
            "repro_monitor_calls_total",
            "GEMM dispatches folded by the numerics monitor", ("site",))
        self._macs = reg.counter(
            "repro_monitor_macs_total", "MACs observed by the numerics monitor", ("site",))
        self._overflow = reg.counter(
            "repro_overflow_events_total",
            "overflow/saturation events (accumulator wrap risk, non-finite "
            "outputs, quantized-collective spillover)", ("site", "source"))
        self._status_g = reg.gauge(
            "repro_envelope_status",
            "per-site envelope status (0 inside, 1 near-edge, 2 violated, "
            "-1 no envelope)", ("site",))

    # -- alerting ----------------------------------------------------------
    def add_alert_sink(self, sink) -> None:
        """``sink(site, status, detail)`` fires on every status escalation
        (inside -> near-edge -> violated), once per site per level."""
        self.alert_sinks.append(sink)

    def _maybe_alert(self, site: str, info: dict) -> None:
        # called with self._lock NOT held (sinks are user code)
        status = info["status"]
        rank = STATUS_CODE.get(status, -1)
        with self._lock:
            prev = self._alerted.get(site, 0)
            if rank <= prev:
                return
            self._alerted[site] = rank
        if rank >= STATUS_CODE[NEAR_EDGE]:
            for sink in list(self.alert_sinks):
                sink(site, status, info)

    # -- recording ---------------------------------------------------------
    def _record(self, site, batch, m, n, k, msb_cap,
                a_max, a_min, b_max, b_min, o_max, finite):
        a_max, a_min = float(a_max), float(a_min)
        b_max, b_min = float(b_max), float(b_min)
        o_max, finite = float(o_max), bool(finite)

        ea_hi, ea_lo = _floor_log2(a_max), _floor_log2(a_min)
        eb_hi, eb_lo = _floor_log2(b_max), _floor_log2(b_min)
        eo_hi = _floor_log2(o_max)
        growth = max(1, math.ceil(math.log2(max(k, 2))))
        msb_req = (None if ea_hi is None or eb_hi is None
                   else ea_hi + eb_hi + 1 + growth + 1)
        wrapped = msb_cap is not None and msb_req is not None and msb_req > msb_cap
        cancel = 0.0
        if o_max > 0.0 and a_max > 0.0 and b_max > 0.0:
            ratio = a_max * b_max * max(k, 1) / o_max
            if ratio > 0.0 and math.isfinite(ratio):   # inf/inf -> nan guard
                cancel = max(0.0, math.log2(ratio))

        with self._lock:
            st = self._stats.get(site)
            if st is None:
                st = self._stats[site] = SiteStats(site)
            st.calls += 1
            st.macs += batch * m * n * k
            st.max_k = max(st.max_k, k)
            st.msb_capacity = msb_cap
            for attr, v, hi in (("a_exp_max", ea_hi, True), ("a_exp_min", ea_lo, False),
                                ("b_exp_max", eb_hi, True), ("b_exp_min", eb_lo, False),
                                ("out_exp_max", eo_hi, True)):
                if v is None:
                    continue
                cur = getattr(st, attr)
                setattr(st, attr, v if cur is None else (max(cur, v) if hi else min(cur, v)))
            st.cancel_bits_max = max(st.cancel_bits_max, cancel)
            if wrapped:
                st.wrap_events += 1
            if not finite:
                st.nonfinite_events += 1
        self._calls.inc(site=site)
        self._macs.inc(batch * m * n * k, site=site)
        if wrapped:
            self._overflow.inc(site=site, source="gemm_wrap")
        if not finite:
            self._overflow.inc(site=site, source="gemm_nonfinite")
        info = self._status(site)
        self._status_g.set(STATUS_CODE[info["status"]], site=site)
        self._maybe_alert(site, info)

    def hook(self, site, cfg, a, b, out):
        """Dispatch trace hook: three (or five) device scalars a call, queued
        with the call's static shape; no host read (module docstring)."""
        if a.ndim < 2 or b.ndim < 2:
            return
        m, k = a.shape[-2], a.shape[-1]
        n = b.shape[-1]
        batch = _batch(a.shape[:-2], b.shape[:-2])
        msb_cap, _ = cfg_capacity(cfg)
        # Low-side tracking (smallest nonzero magnitude) only matters on
        # fixed-point sites — a finite envelope lsb. Native float sites skip
        # those two reductions.
        env = self._site_envelope(site)
        need_lo = env is not None and env.get("lsb") is not None
        with torch.no_grad():
            af = _as_float(cfg.fmt, a)               # posit carriers decode
            bf = _as_float(cfg.fmt, b)
            vals = [_absmax(af), _absmax(bf), _absmax(out)]
            if need_lo:
                vals += [_absmin_nz(af), _absmin_nz(bf)]
            vals = torch.stack(vals)
        with self._lock:
            self._queue.append((site, batch, m, n, k, msb_cap, vals))
            full = len(self._queue) >= FOLD_AT
        if full:
            self.fold()

    def fold(self) -> None:
        """Fold every queued dispatch into the per-site stats: one
        device-to-host copy of the queued scalars (per device), then the
        reference's ``_record`` per dispatch, in dispatch order."""
        with self._fold_lock:
            with self._lock:
                queue, self._queue = self._queue, []
            if not queue:
                return
            by_dev: dict = {}
            for i, entry in enumerate(queue):
                by_dev.setdefault(entry[-1].device, []).append(i)
            host = [None] * len(queue)
            for idx in by_dev.values():
                flat = torch.cat([queue[i][-1] for i in idx]).cpu().tolist()
                at = 0
                for i in idx:
                    n = queue[i][-1].numel()
                    host[i], at = flat[at:at + n], at + n
            self.folds += 1
            for entry, row in zip(queue, host):
                a_max, b_max, o_max = row[:3]
                a_min, b_min = row[3:] or (0.0, 0.0)
                # all outputs finite <=> their |out| max is (NaN propagates)
                self._record(*entry[:-1], a_max, a_min, b_max, b_min, o_max,
                             math.isfinite(o_max))

    # -- installation ------------------------------------------------------
    def install(self) -> "NumericsMonitor":
        if self._remove is None:
            self._remove = dispatch.add_trace_hook(self.hook)
        return self

    def uninstall(self) -> None:
        if self._remove is not None:
            self._remove()
            self._remove = None
        self.fold()                  # land in-flight records before readers

    def __enter__(self) -> "NumericsMonitor":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- classification ----------------------------------------------------
    def _site_envelope(self, site: str) -> Optional[dict]:
        env = self.envelope.get(site)
        if env is None and "@" in site:
            # backward/aux-qualified keys may monitor under a fwd-only
            # envelope; no guess — absent means absent
            return None
        return env

    def status(self, site: str) -> dict:
        """Classify one site's live fold against its envelope entry."""
        self.fold()
        return self._status(site)

    def _status(self, site: str) -> dict:
        with self._lock:
            st = self._stats.get(site)
            live = st.to_dict() if st is not None else None
        env = self._site_envelope(site)
        if env is None:
            return {"site": site, "status": UNMONITORED, "live": live,
                    "detail": "no calibration envelope for this site"}
        if live is None:
            return {"site": site, "status": INSIDE, "envelope": env, "live": None,
                    "detail": "no live traffic yet"}

        detail = []
        status = INSIDE
        if live["wrap_events"] or live["nonfinite_events"]:
            status = VIOLATED
            detail.append(f"{live['wrap_events']} accumulator-wrap and "
                          f"{live['nonfinite_events']} non-finite events")
        msb_cap = env.get("msb")
        msb_req = live["msb_required"]
        if status != VIOLATED and msb_cap is not None and msb_req is not None:
            if msb_req > msb_cap:
                status = VIOLATED
                detail.append(f"live msb requirement {msb_req} exceeds "
                              f"deployed capacity {msb_cap}")
            elif msb_req > msb_cap - self.margin_bits:
                status = NEAR_EDGE
                detail.append(f"msb headroom {msb_cap - msb_req} bits "
                              f"< margin {self.margin_bits}")
        if status == INSIDE:
            check_lo = env.get("lsb") is not None
            for op, rng in (("a", env.get("a_exp")), ("b", env.get("b_exp"))):
                lo, hi = live[f"{op}_exp"]
                if _exp_outside(lo, hi, rng, self.exp_grace, check_lo):
                    status = NEAR_EDGE
                    detail.append(f"{op} exponents [{lo},{hi}] left the traced range "
                                  f"{rng} (+{self.exp_grace} grace bits)")
        return {"site": site, "status": status, "envelope": env, "live": live,
                "detail": "; ".join(detail) or "within calibrated envelope"}

    def statuses(self) -> dict:
        """Every known site (live or enveloped) -> status document."""
        self.fold()
        with self._lock:
            sites = set(self._stats)
        sites |= set(self.envelope)
        return {s: self._status(s) for s in sorted(sites)}

    def worst_status(self) -> str:
        worst = INSIDE
        for info in self.statuses().values():
            if STATUS_CODE[info["status"]] > STATUS_CODE[worst]:
                worst = info["status"]
        return worst

    def overflow_events(self) -> int:
        self.fold()
        with self._lock:
            return sum(s.wrap_events + s.nonfinite_events for s in self._stats.values())

    def snapshot(self) -> dict:
        """JSON-able monitor summary (embedded in ``--metrics-dump``)."""
        return {"kind": "repro.obs.MonitorSnapshot",
                "version": ENVELOPE_VERSION,
                "worst_status": self.worst_status(),
                "overflow_events": self.overflow_events(),
                "sites": {s: {k: v for k, v in info.items() if k != "site"}
                          for s, info in self.statuses().items()}}


@contextlib.contextmanager
def monitoring(plan=None, *, envelope: Optional[dict] = None, **kw):
    """Monitor every dispatched GEMM in the block against ``plan``'s
    calibration envelope (``plan.meta['envelope']``); yields the monitor for
    status queries after (or during) the block."""
    if envelope is None and plan is not None:
        envelope = (getattr(plan, "meta", None) or {}).get("envelope")
    mon = NumericsMonitor(envelope, **kw)
    with mon:
        yield mon
