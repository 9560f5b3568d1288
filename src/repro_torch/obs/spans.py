"""repro_torch.obs.spans — lightweight trace spans for serving and training
(a copy of ``repro.obs.spans``).

A span is a named, attributed time interval: ``with span("prefill", plan=...,
bucket=...):`` for scoped work, or ``sp = start_span(...); ...; sp.end()``
for lifecycles that cross function boundaries. Completed spans land in a
bounded in-process recorder and export as Chrome-trace/Perfetto JSON via
:mod:`repro_torch.obs.export` (open in ``chrome://tracing`` or
https://ui.perfetto.dev). ``launch.batching.ContinuousBatcher.run`` records
``serving.batcher_run``.

Cost model: recording is a perf_counter pair, a dict, and a deque append —
cheap enough to leave on per decode step. Host clock only: a span around
asynchronous CUDA work measures its enqueue unless the work ends in a
synchronization (the batcher's step reads its tokens back, so its spans
cover the device work). The recorder is a ring buffer (default 20k events)
so long-running servers never grow without bound; the drop count is
reported so truncation is visible, not silent.

Energy attribution: :func:`plan_energy_per_token` folds a deployed
``PrecisionPlan``'s per-site MAC counts through ``core.energy.gemm_power``
into joules per token (the paper's modeled-energy axis, not a measurement
of any card).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

_T0 = time.perf_counter()          # process-relative epoch for trace ts


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


class SpanRecorder:
    """Bounded, thread-safe store of completed span events."""

    def __init__(self, limit: int = 20000):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=limit)
        self.dropped = 0
        self.enabled = True

    def record(self, event: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_RECORDER = SpanRecorder()
_TLS = threading.local()


def recorder() -> SpanRecorder:
    return _RECORDER


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class Span:
    """One in-flight interval. ``end()`` is idempotent; extra keyword args
    to ``end`` merge into the recorded attributes (steps, tokens, energy)."""

    __slots__ = ("name", "args", "_t0", "_ts_us", "_tid", "_ended",
                 "_recorder", "_on_stack")

    def __init__(self, name: str, args: dict, rec: SpanRecorder,
                 on_stack: bool):
        self.name = name
        self.args = args
        self._recorder = rec
        self._t0 = time.perf_counter()
        self._ts_us = _now_us()
        self._tid = threading.get_ident()
        self._ended = False
        self._on_stack = on_stack

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def annotate(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    def end(self, **kw) -> float:
        """Close the span, record it, return its duration in seconds."""
        dur = self.elapsed
        if self._ended:
            return dur
        self._ended = True
        if kw:
            self.args.update(kw)
        if self._on_stack:
            st = _stack()
            if st and st[-1] is self:
                st.pop()
        self._recorder.record({
            "name": self.name,
            "ts_us": self._ts_us,
            "dur_us": dur * 1e6,
            "pid": os.getpid(),
            "tid": self._tid,
            "args": {k: v for k, v in self.args.items() if v is not None},
        })
        return dur


def start_span(name: str, **args) -> Span:
    """Open a span whose end crosses scopes (request lifecycles). Manually
    started spans do not join the thread-local nesting stack — nesting is a
    lexical-scope concept and these are not lexically scoped."""
    return Span(name, dict(args), _RECORDER, on_stack=False)


@contextlib.contextmanager
def span(name: str, **args):
    """Scoped span; nests via a thread-local stack (``current_span()`` lets
    inner code annotate the enclosing interval)."""
    sp = Span(name, dict(args), _RECORDER, on_stack=True)
    _stack().append(sp)
    try:
        yield sp
    finally:
        sp.end()


def current_span():
    st = _stack()
    return st[-1] if st else None


# ---------------------------------------------------------------------------
# energy attribution
# ---------------------------------------------------------------------------
def plan_energy_per_token(plan) -> float:
    """Joules/token a deployed ``PrecisionPlan`` models: each GEMM site's
    traced MAC count folded through ``core.energy.gemm_power`` for the site's
    ⟨format, accumulator⟩, divided by the calibration token count recorded in
    ``meta["envelope"]["traced_tokens"]``. Returns 0.0 when the plan predates
    envelopes (no traced token count → no honest per-token rate)."""
    env = (plan.meta or {}).get("envelope") or {}
    tokens = env.get("traced_tokens")
    if not tokens:
        return 0.0
    from repro_torch.core.energy import gemm_power   # lazy: keep obs import-light
    total = 0.0
    for s in plan.gemm_sites():
        if s.energy_j is not None:
            total += s.energy_j
        elif s.macs:
            total += gemm_power(s.cfg.fmt, s.cfg.acc).energy_joules(s.macs)
    return total / float(tokens)
