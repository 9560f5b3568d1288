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
computes the reference's device scalars: |a| max, |b| max, |out| max, and
the nonzero |a| and |b| min only where the site's envelope has an ``lsb``.
All-finite is read from |out| max, through which a NaN or an infinity
propagates. Where they go depends on how the step runs:

* **Eager**: they are queued, with the call's static shape and a stamp of
  the monitor's device clock, and folded on the host by the reference's
  ``_record``, in one device-to-host copy per device. The fold happens
  whenever a reader asks (``status``, ``statuses``, ``worst_status``,
  ``overflow_events``, ``snapshot``), when the queue reaches ``FOLD_AT``
  entries, and at ``uninstall``/``__exit__`` (the reference's
  ``jax.effects_barrier()``).
* **In a CUDA graph**: the monitor is a capturable hook
  (``core.dispatch``, "Trace hooks"). ``launch.batching.capture`` tells it
  of each eager warm-up call, where it records only the dispatches' static
  shapes, and of the capture. Before the capture it allocates one
  ``(n, 10)`` float64 block of rows, one row for each of the warm-up's n
  dispatches. The k-th dispatch of the captured body computes its
  scalars for the k-th row. After the body, ``CapturedRecord.seal``
  captures one update of every row, in place: the running maxima and
  minima, the calls, the calls whose own msb requirement exceeds the
  site's capacity, the calls with a non-finite |out| max, the largest
  cancellation ratio (float64) and the clock's stamp. Every replay thus
  adds one call's record to each row, and reads nothing back to the host.
  A fold reads the rows with the queue (still one copy per device) and
  folds each row's calls since the last fold, in stamp order, with the
  stats, counters, gauges and alert sinks that ``_record`` would have left
  after the same calls one by one. The sites' values are the same;
  ``msb_capacity`` is the last-stamped call's, as in the eager order. An
  escalation that passes through ``near-edge`` to ``violated`` within one
  row's fold alerts once, at ``violated``.

This is the reference's "compile once, record every execution": its
monitor stages reductions and one ``jax.debug.callback`` at trace time.
As there, a step captured before ``install()`` stays unmonitored, and a
record of a freed engine stays in the monitor until it has been folded.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
import threading
import weakref
from typing import NamedTuple, Optional

import torch

from repro_torch.core import dispatch
from repro_torch.device import capturing
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

# The columns of a captured dispatch's row (float64): the running maxima of
# |a|, |b| and |out| (0 until a positive finite value), the running minima
# of the nonzero |a| and |b| (inf until one), the calls, the wrap and
# non-finite events among them, the largest cancellation ratio (0 until a
# finite positive one) and the clock's stamp of the last call. A
# dispatch's scalars come in the order of the first five.
A_MAX, B_MAX, O_MAX, A_MIN, B_MIN, CALLS, WRAPS, NONFINITE, RATIO, STAMP = range(10)
ROW_INIT = (0.0, 0.0, 0.0, math.inf, math.inf, 0.0, 0.0, 0.0, 0.0, 0.0)


def _floor_log2(v: float) -> Optional[int]:
    if not (v > 0.0) or not math.isfinite(v):
        return None
    return math.frexp(v)[1] - 1


def _growth(k: int) -> int:
    """Carry bits a sum of ``k`` products may need."""
    return max(1, math.ceil(math.log2(max(k, 2))))


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
        return p + _growth(self.max_k) + 1

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


def _floor_log2_t(x: torch.Tensor) -> tuple:
    """``_floor_log2`` on the device, elementwise: (floor(log2 x), valid),
    valid where the host's is not None. The values are widened to float64
    first, where a float32 subnormal is a normal number."""
    x = x.double()
    return torch.frexp(x)[1] - 1, (x > 0) & torch.isfinite(x)


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


def _reduce(cfg, a, b, out, need_lo: bool) -> list:
    """|a| max, |b| max, |out| max (and the nonzero |a| and |b| min where
    ``need_lo``) as float32 scalars, in the order of a row's columns."""
    af = _as_float(cfg.fmt, a)                       # posit carriers decode
    bf = _as_float(cfg.fmt, b)
    vals = [_absmax(af), _absmax(bf), _absmax(out)]
    if need_lo:
        vals += [_absmin_nz(af), _absmin_nz(bf)]
    return vals


class _Call(NamedTuple):
    """A dispatch's static shape, as the monitor records it."""
    site: str
    batch: int
    m: int
    n: int
    k: int
    msb_cap: Optional[int]
    need_lo: bool
    device: torch.device


class _Rows:
    """The monitor's hold on a capture's rows: their tensor (kept alive
    after the record is freed, until folded), the calls they record, the
    counts already folded, and a weak reference to the record."""

    def __init__(self, record, rows, calls):
        self.record, self.rows, self.calls = record, rows, calls
        self.seen = [(0, 0, 0)] * len(calls)


class CapturedRecord:
    """The rows of one captured body (module docstring): built from the
    warm-up's dispatches outside the capture; while ``recording()``, the
    k-th dispatch's scalars are kept as row k's, and ``seal()`` folds them
    into ``rows`` in place. Under a capture both are recorded (the scalars'
    tensors, allocated in the graph's pool, are held here for the graph's
    life), so every replay adds one call to every row; run eagerly (the CPU
    tests), each recording and seal adds one."""

    def __init__(self, monitor: NumericsMonitor, calls: list):
        self.calls, self.sealed, self._next = calls, False, 0
        self.vals: list = [None] * len(calls)
        self._tls = monitor._tls
        if not calls:
            return
        dev = calls[0].device
        n = len(calls)
        f64 = dict(dtype=torch.float64, device=dev)
        with torch.inference_mode(False):
            # the two minima of a row whose envelope has no lsb: none
            self.zero = torch.zeros((), dtype=torch.float32, device=dev)
            self.rows = torch.tensor([ROW_INIT] * n, dtype=torch.float64).to(dev)
            self.kk = torch.tensor([float(max(c.k, 1)) for c in calls], **f64)
            # a call wraps where floor_log2(|a| max) + floor_log2(|b| max)
            # exceeds this (its msb requirement exceeds the capacity)
            self.wrap_at = torch.tensor(
                [math.inf if c.msb_cap is None else float(c.msb_cap - 2 - _growth(c.k))
                 for c in calls], **f64)
            self.steps = torch.arange(1, n + 1, **f64)
            self.empty = torch.tensor(ROW_INIT[:5], **f64)
            self.clock = monitor._clock(dev)

    @contextlib.contextmanager
    def recording(self):
        """The monitor's dispatches go to this record, row by row."""
        self._next, self.sealed = 0, False
        self._tls.active = self
        try:
            yield self
        finally:
            self._tls.active = None

    def dispatch(self, call, cfg, a, b, out) -> None:
        k = self._next
        if k >= len(self.calls) or call != self.calls[k]:
            want = self.calls[k] if k < len(self.calls) else "nothing"
            raise RuntimeError(f"dispatch {k} of the captured body is {call}; its warm-up "
                               f"call dispatched {want}")
        with torch.no_grad():
            vals = _reduce(cfg, a, b, out, call.need_lo)
        self.vals[k] = vals + [self.zero] * (5 - len(vals))
        self._next = k + 1

    def seal(self) -> None:
        """One call of every row: fold the dispatches' scalars into the rows
        in place."""
        if self._next != len(self.calls):
            raise RuntimeError(f"the captured body dispatched {self._next} GEMMs; its "
                               f"warm-up call dispatched {len(self.calls)}")
        self.sealed = True
        if not self.calls:
            return
        with torch.no_grad():
            s = torch.stack([v for row in self.vals for v in row]).view(-1, 5).double()
            exp, valid = _floor_log2_t(s)
            wrap = valid[:, A_MAX] & valid[:, B_MAX] & (
                exp[:, A_MAX] + exp[:, B_MAX] > self.wrap_at)
            ratio = s[:, A_MAX] * s[:, B_MAX] * self.kk / s[:, O_MAX]
            ratio_ok = (s[:, :3] > 0).all(1) & (ratio > 0) & torch.isfinite(ratio)
            nonfinite = ~torch.isfinite(s[:, O_MAX])
            seen = torch.where(valid, s, self.empty)
            r = self.rows
            self.rows.copy_(torch.cat((
                torch.maximum(r[:, :3], seen[:, :3]),
                torch.minimum(r[:, 3:5], seen[:, 3:5]),
                r[:, CALLS:RATIO] + torch.stack((torch.ones_like(ratio), wrap.double(),
                                                 nonfinite.double()), 1),
                torch.maximum(r[:, RATIO], torch.where(ratio_ok, ratio, 0.0))[:, None],
                (self.clock + self.steps)[:, None]), 1))
            self.clock.add_(len(self.calls))


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
    ``folds`` counts the device-to-host copies the monitor made. A step
    captured while the monitor is installed records into it at every
    replay, even after ``uninstall``; one captured before ``install`` stays
    unmonitored, as a function the reference compiled before its monitor
    was installed.
    """

    def __init__(self, envelope: Optional[dict] = None, *,
                 registry: Optional[_registry.Registry] = None,
                 margin_bits: int = 2, exp_grace: int = 2, alert_sink=None):
        self._lock = threading.Lock()
        self._fold_lock = threading.RLock()
        self._stats: dict = {}
        self._alerted: dict = {}
        self._queue: list = []
        self._captured: list = []        # _Rows of the captures, until folded and freed
        self._clocks: dict = {}
        self._tls = threading.local()
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
        """One call, as the reference's ``_record``."""
        a_max, a_min = float(a_max), float(a_min)
        b_max, b_min = float(b_max), float(b_min)
        o_max, finite = float(o_max), bool(finite)

        ea_hi, eb_hi = _floor_log2(a_max), _floor_log2(b_max)
        msb_req = (None if ea_hi is None or eb_hi is None
                   else ea_hi + eb_hi + 1 + _growth(k) + 1)
        wrapped = msb_cap is not None and msb_req is not None and msb_req > msb_cap
        ratio = 0.0
        if o_max > 0.0 and a_max > 0.0 and b_max > 0.0:
            ratio = a_max * b_max * max(k, 1) / o_max
        self._fold_calls(site, 1, batch * m * n * k, k, msb_cap,
                         (a_max, a_min, b_max, b_min, o_max), ratio, int(wrapped),
                         int(not finite))

    def _fold_calls(self, site, calls, macs, k, msb_cap, values, ratio, wraps, nonfinite):
        """Fold ``calls`` calls of one site: ``values`` are the largest |a|,
        smallest nonzero |a|, largest |b|, smallest nonzero |b| and largest
        |out| over them (their exponents fold as the reference's per-call
        ones, ``_floor_log2`` being monotone), ``ratio`` their largest
        cancellation ratio."""
        ea_hi, ea_lo, eb_hi, eb_lo, eo_hi = map(_floor_log2, values)
        cancel = 0.0
        if ratio > 0.0 and math.isfinite(ratio):        # inf/inf -> nan guard
            cancel = max(0.0, math.log2(ratio))

        with self._lock:
            st = self._stats.get(site)
            if st is None:
                st = self._stats[site] = SiteStats(site)
            st.calls += calls
            st.macs += macs
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
            st.wrap_events += wraps
            st.nonfinite_events += nonfinite
        self._calls.inc(calls, site=site)
        self._macs.inc(macs, site=site)
        if wraps:
            self._overflow.inc(wraps, site=site, source="gemm_wrap")
        if nonfinite:
            self._overflow.inc(nonfinite, site=site, source="gemm_nonfinite")
        info = self._status(site)
        self._status_g.set(STATUS_CODE[info["status"]], site=site)
        self._maybe_alert(site, info)

    def _call(self, site, cfg, a, b) -> "_Call":
        env = self._site_envelope(site)
        # Low-side tracking (smallest nonzero magnitude) only matters on
        # fixed-point sites — a finite envelope lsb. Native float sites skip
        # those two reductions.
        return _Call(site, _batch(a.shape[:-2], b.shape[:-2]), a.shape[-2], b.shape[-1],
                     a.shape[-1], cfg_capacity(cfg)[0],
                     env is not None and env.get("lsb") is not None, a.device)

    def hook(self, site, cfg, a, b, out):
        """Dispatch trace hook: three (or five) device scalars a call, and
        no host read (module docstring). In a warm-up call it records the
        call's static shape only; in a capture, the scalars go to the
        call's row of the capture's record; else they are queued with a
        stamp of the clock."""
        if a.ndim < 2 or b.ndim < 2:
            return
        call = self._call(site, cfg, a, b)
        active = getattr(self._tls, "active", None)
        if isinstance(active, list):                 # a warm-up call
            active.append(call)
            return
        if active is not None:
            active.dispatch(call, cfg, a, b, out)
            return
        if capturing():
            raise RuntimeError(
                "a monitored GEMM dispatched under a CUDA-graph capture that did not "
                "tell the monitor: its scalars would be garbage (capture through "
                "launch.batching.capture)")
        with torch.no_grad():
            vals = torch.stack(_reduce(cfg, a, b, out, call.need_lo))
            # the clock's count of replayed captured calls stamps the call:
            # it follows every row stamped up to that count (0 before any
            # capture on the device, with no kernel)
            clock = self._clocks.get(a.device)
            stamp = 0.0 if clock is None else clock.clone()
        with self._lock:
            self._queue.append((call, vals, stamp))
            full = len(self._queue) >= FOLD_AT
        if full:
            self.fold()

    __call__ = hook
    capturable = True

    def _clock(self, device) -> torch.Tensor:
        """The monitor's device clock on ``device`` (a 0-d float64 count of
        the captured calls replayed there): a replayed row's stamp is its
        count, a queued call's the count so far, so a fold knows their
        order."""
        with self._lock:
            clock = self._clocks.get(device)
            if clock is None:
                with torch.inference_mode(False):
                    clock = self._clocks[device] = torch.zeros(
                        (), dtype=torch.float64, device=device)
            return clock

    # -- capture (launch.batching.capture) ----------------------------------
    @contextlib.contextmanager
    def warmup(self):
        """Around one eager warm-up call of a body about to be captured: the
        dispatches are recorded by their static shape only, for the
        capture's rows."""
        calls: list = []
        self._tls.active = calls
        try:
            yield
        finally:
            self._tls.active = None
        self._tls.warm = calls

    @contextlib.contextmanager
    def capture(self):
        """Entered before a graph's capture begins and left after it ends:
        yields the ``CapturedRecord`` of the last warm-up call's dispatches,
        whose ``seal()`` the capture calls after the body. The record's rows
        join the monitor's folds once the capture has succeeded. A fold on
        another thread waits for the capture to end: its copy to the host
        would break the capture."""
        calls = getattr(self._tls, "warm", None)
        self._tls.warm = None
        if calls is None:
            raise RuntimeError("a monitored capture needs a warm-up call first: the "
                               "monitor sizes its rows from its dispatches")
        with self._fold_lock:
            rec = CapturedRecord(self, calls)
            with rec.recording():
                yield rec
            if not rec.sealed:
                raise RuntimeError("the capture ended without sealing the monitor's record")
            if calls:
                with self._lock:
                    self._captured.append(_Rows(weakref.ref(rec), rec.rows, calls))

    def fold(self) -> None:
        """Fold every queued dispatch and every captured row's calls since
        the last fold into the per-site stats: one device-to-host copy per
        device, then the reference's ``_record`` per queued dispatch and
        ``_fold_calls`` per row, in the order of their stamps."""
        with self._fold_lock:
            with self._lock:
                queue, self._queue = self._queue, []
                captured = list(self._captured)
            # a record freed before the read has no replay after it: its
            # rows leave the monitor once folded
            freed = {id(b) for b in captured if b.record() is None}
            if not queue and not captured:
                return
            by_dev: dict = {}
            for entry in queue:
                by_dev.setdefault(entry[1].device, ([], []))[0].append(entry)
            for rows in captured:
                by_dev.setdefault(rows.rows.device, ([], []))[1].append(rows)
            items = []          # (device, stamp, 0 a row / 1 a queued call, fold)
            for d, (entries, blocks) in enumerate(by_dev.values()):
                # float64 throughout, so the one copy is one same-dtype cat
                parts = [torch.cat([e[1] for e in entries]).double()] if entries else []
                parts += [e[2].view(1) for e in entries if torch.is_tensor(e[2])]
                parts += [b.rows.reshape(-1) for b in blocks]
                flat = iter(torch.cat(parts).cpu().tolist())

                def take(n):
                    return list(itertools.islice(flat, n))
                queued = [take(e[1].numel()) for e in entries]
                stamps = [take(1)[0] if torch.is_tensor(e[2]) else e[2] for e in entries]
                for (call, _, _), row, stamp in zip(entries, queued, stamps):
                    items.append((d, stamp, 1,
                                  functools.partial(self._fold_queued, call, row)))
                for b in blocks:
                    block = take(b.rows.numel())
                    for i in range(len(b.calls)):
                        row = block[10 * i:10 * (i + 1)]
                        if row[CALLS] > b.seen[i][0]:
                            items.append((d, row[STAMP], 0,
                                          functools.partial(self._fold_row, b, i, row)))
            self.folds += 1
            items.sort(key=lambda it: it[:3])
            for *_, fold in items:
                fold()
            with self._lock:
                self._captured = [b for b in self._captured if id(b) not in freed]

    def _fold_queued(self, call, row) -> None:
        a_max, b_max, o_max = row[:3]
        a_min, b_min = row[3:] or (0.0, 0.0)
        # all outputs finite <=> their |out| max is (NaN propagates)
        self._record(call.site, call.batch, call.m, call.n, call.k, call.msb_cap,
                     a_max, a_min, b_max, b_min, o_max, math.isfinite(o_max))

    def _fold_row(self, block, i, row) -> None:
        call, seen = block.calls[i], block.seen[i]
        calls, wraps, nonfinite = (int(row[c]) - s for c, s in
                                   zip((CALLS, WRAPS, NONFINITE), seen))
        block.seen[i] = (int(row[CALLS]), int(row[WRAPS]), int(row[NONFINITE]))
        self._fold_calls(call.site, calls, call.batch * call.m * call.n * call.k * calls,
                         call.k, call.msb_cap,
                         (row[A_MAX], row[A_MIN], row[B_MAX], row[B_MIN], row[O_MAX]),
                         row[RATIO], wraps, nonfinite)

    # -- installation ------------------------------------------------------
    def install(self) -> "NumericsMonitor":
        if self._remove is None:
            self._remove = dispatch.add_trace_hook(self)
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
