"""Serving frontend: request queue, admission control, backpressure, futures
(counterpart of ``repro.serving.frontend``).

The layer between clients and the engine pool. A ``ServeRequest`` declares
its workload class (or an explicit plan), its method, and its constraints;
``submit`` routes it (``PlanRouter``), picks its bucket (padded dispatch),
and returns a ``Completion`` future immediately. ``run`` is the cooperative
event loop: it activates (plan, bucket, method) groups under a
``max_live_batches`` backpressure cap, feeds engines only what their KV
budget admits (parking the rest, never truncating), recycles drained
engines whose cursor ran out of room, steps every live engine in turn, and
resolves futures as requests finish. Streaming requests get their tokens
through ``on_token`` callbacks from inside the decode step that produced
them. On the card each step of a graph engine is one replay and one read
of its argmax ids.

Typed failure surface: ``RoutingError`` (no plan satisfies the request) and
``AdmissionError`` (no bucket fits / queue at cap) resolve the future as
rejected — one bad request never takes the loop down.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, OrderedDict, deque
from typing import Callable, Optional

from repro_torch.launch.batching import Request
from repro_torch.obs.registry import default_registry
from repro_torch.obs.spans import plan_energy_per_token, span, start_span
from .engine import METHODS, AdmissionError, BucketedEnginePool, GenerateEngine
from .router import PlanRouter, RoutingError


@dataclasses.dataclass
class ServeRequest:
    """One client request. ``workload`` is a class (chat/solve/repro) or an
    explicit plan name; ``method`` one of score/generate/stream."""

    uid: int
    prompt: list
    max_new: int = 16
    workload: str = "chat"
    method: str = "generate"
    min_bits: Optional[float] = None
    bit_stable: bool = False
    on_token: Optional[Callable[[int], None]] = None   # stream delivery


class Completion:
    """Per-request completion future (host-side: the loop is cooperative).
    ``result()`` returns generated tokens (generate/stream) or the prompt
    log-probability (score); rejected requests re-raise their typed error."""

    def __init__(self, request: ServeRequest):
        self.request = request
        self.done = False
        self.error: Optional[Exception] = None
        self.tokens: Optional[list] = None
        self.score: Optional[float] = None
        self.plan: Optional[str] = None
        self.bucket: Optional[str] = None
        self.steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self._span = None                 # serving.request lifecycle span

    @property
    def ok(self) -> bool:
        return self.done and self.error is None

    def result(self):
        if not self.done:
            raise RuntimeError(f"request {self.request.uid} still pending — "
                               "drive the frontend with run()")
        if self.error is not None:
            raise self.error
        return self.score if self.request.method == "score" else self.tokens

    def _reject(self, err: Exception) -> "Completion":
        self.error, self.done = err, True
        return self


class RoutedFrontend:
    """Routing + buckets + backpressure in front of a BucketedEnginePool."""

    def __init__(self, pool: BucketedEnginePool, router: PlanRouter,
                 max_live_batches: int = 2, max_queue: int = 256):
        self.pool, self.router = pool, router
        self.max_live_batches = max_live_batches
        self.max_queue = max_queue
        # (plan_name, bucket, method) -> deque[Completion]; OrderedDict so
        # group activation is FIFO in first-arrival order
        self._groups: OrderedDict = OrderedDict()
        self._live: dict = {}                 # group key -> engine
        self._inflight: dict = {}             # uid -> (Completion, Request)
        self._completed: list = []
        self.stats_by_class: dict = {}
        self._wall = 0.0
        # registry mirrors of the per-instance dicts (the dicts stay the
        # exact source of truth for this frontend)
        reg = default_registry()
        self._m_requests = reg.counter(
            "repro_serving_requests_total", "request lifecycle events",
            ("workload", "event"))
        self._m_tokens = reg.counter(
            "repro_serving_tokens_total", "tokens processed by the serving loop",
            ("workload", "kind"))
        self._m_parked = reg.gauge("repro_serving_parked", "requests parked in group queues")
        self._m_run = reg.histogram("repro_serving_run_seconds",
                                    "RoutedFrontend.run() wall time")
        self._m_energy = reg.counter(
            "repro_serving_energy_joules_total",
            "modeled GEMM energy attributed to completed requests", ("plan",))
        self._energy_per_token: dict = {}     # plan name -> J/token (cached)

    # -- submission ---------------------------------------------------------
    def submit(self, req: ServeRequest) -> Completion:
        comp = Completion(req)
        st = self._class_stats(req.workload)
        st["submitted"] += 1
        self._m_requests.inc(workload=req.workload, event="submitted")
        comp._span = start_span("serving.request", uid=req.uid, workload=req.workload,
                                method=req.method)
        try:
            if req.method not in METHODS:
                raise AdmissionError(f"unknown method {req.method!r}")
            with span("serving.route", uid=req.uid, workload=req.workload):
                plan = self.router.route(req.workload, min_bits=req.min_bits,
                                         bit_stable=req.bit_stable)
                bucket = self.pool.bucket_for(
                    len(req.prompt), 0 if req.method == "score" else req.max_new)
            if self._queued() >= self.max_queue:
                raise AdmissionError(f"queue at backpressure cap ({self.max_queue}); retry")
        except (RoutingError, AdmissionError) as e:
            st["rejected"] += 1
            self._m_requests.inc(workload=req.workload, event="rejected")
            comp._span.end(status="rejected", reason=type(e).__name__)
            return comp._reject(e)
        comp.plan, comp.bucket = plan.name, bucket.label
        comp._span.annotate(plan=plan.name, bucket=bucket.label)
        st["plans"][plan.name] += 1
        key = (plan.name, bucket, req.method)
        self._groups.setdefault(key, deque()).append(comp)
        self._m_parked.set(float(self._queued()))
        return comp

    def _queued(self) -> int:
        return sum(len(q) for q in self._groups.values())

    def _class_stats(self, workload: str) -> dict:
        return self.stats_by_class.setdefault(workload, {
            "submitted": 0, "rejected": 0, "completed": 0, "steps": 0,
            "prefill_tokens": 0, "decode_tokens": 0, "plans": Counter()})

    # -- the event loop -----------------------------------------------------
    def run(self, max_steps: int = 100_000) -> list:
        """Drive until every submitted request resolves. Returns the
        completions resolved during this call."""
        t0 = time.perf_counter()
        resolved_before = len(self._completed)
        idle_ticks = 0
        with span("serving.run"):
            for _ in range(max_steps):
                if not self._groups and not self._inflight:
                    break
                activated = self._activate_groups()
                self._feed_live()
                progressed = self._step_live()
                self._harvest()
                if progressed or activated:
                    idle_ticks = 0
                    continue
                # one idle tick is legal (an engine retired this tick; a
                # parked group activates on the next); two in a row means
                # nothing can ever move — e.g. max_live_batches=0
                idle_ticks += 1
                if idle_ticks > 1:
                    raise RuntimeError(
                        "frontend stalled: queued groups but nothing live "
                        f"(max_live_batches={self.max_live_batches})")
            else:
                raise RuntimeError(f"frontend did not drain in {max_steps} steps")
        dt = time.perf_counter() - t0
        self._wall += dt
        self._m_run.observe(dt)
        self._m_parked.set(float(self._queued()))
        return self._completed[resolved_before:]

    def _activate_groups(self) -> int:
        """Bring queued groups live under the max-live-batches cap. Score
        groups execute immediately (one-shot, no resident decode state).
        Returns how many groups made progress (activated or scored)."""
        n = 0
        for key in list(self._groups):
            plan_name, bucket, method = key
            if key in self._live:
                continue
            if method == "score":
                self._run_score_group(key)
                n += 1
                continue
            if len(self._live) >= self.max_live_batches:
                continue                      # backpressure: stay parked
            self._live[key] = self.pool.get(self.router[plan_name], bucket, method)
            n += 1
        return n

    def _run_score_group(self, key) -> None:
        plan_name, bucket, _ = key
        q = self._groups.pop(key)
        eng = self.pool.get(self.router[plan_name], bucket, "score")
        while q:
            batch = [q.popleft() for _ in range(min(len(q), bucket.n_slots))]
            scores = eng.score_batch([c.request.prompt for c in batch])
            for comp, s in zip(batch, scores):
                comp.score, comp.done = s, True
                st = self._class_stats(comp.request.workload)
                st["completed"] += 1
                st["prefill_tokens"] += len(comp.request.prompt)
                self._completed.append(comp)
                wl = comp.request.workload
                self._m_requests.inc(workload=wl, event="routed")
                self._m_requests.inc(workload=wl, event="completed")
                self._m_tokens.inc(len(comp.request.prompt), workload=wl, kind="prefill")
                self._attribute_energy(comp, len(comp.request.prompt))
                if comp._span is not None:
                    comp._span.end(status="completed")

    def _feed_live(self) -> None:
        """Admit queued requests into their live engines — only what the
        engine's remaining KV budget fits; recycle a drained engine whose
        cursor ran out; park the rest for the next tick."""
        for key, eng in self._live.items():
            if not isinstance(eng, GenerateEngine):
                continue
            q = self._groups.get(key)
            if not q:
                continue
            while q:
                comp = q[0]
                need = len(comp.request.prompt) + comp.request.max_new
                eng.recycle_if_exhausted(need)
                free = (sum(r is None for r in eng.batcher.active) - len(eng.batcher.queue))
                if need > eng.cache_remaining() or free <= 0:
                    break                     # parked, not truncated
                q.popleft()
                raw = Request(uid=comp.request.uid, prompt=list(comp.request.prompt),
                              max_new=comp.request.max_new, on_token=comp.request.on_token)
                self._inflight[comp.request.uid] = (comp, raw)
                self._m_requests.inc(workload=comp.request.workload, event="routed")
                if comp._span is not None:
                    comp._span.annotate(admitted=True)
                eng.admit(raw)
            if not q:
                self._groups.pop(key, None)

    def _step_live(self) -> bool:
        progressed = False
        for eng in self._live.values():
            if eng.step():
                progressed = True
        return progressed

    def _harvest(self) -> None:
        """Resolve futures for finished requests; retire drained engines
        whose group queue is empty (frees a live-batch slot)."""
        done_uids = [uid for uid, (_, raw) in self._inflight.items() if raw.done]
        for uid in done_uids:
            comp, raw = self._inflight.pop(uid)
            comp.tokens, comp.done = raw.out, True
            comp.steps, comp.prefill_tokens = raw.steps, raw.prefill_tokens
            comp.decode_tokens = raw.decode_tokens
            st = self._class_stats(comp.request.workload)
            st["completed"] += 1
            st["steps"] += raw.steps
            st["prefill_tokens"] += raw.prefill_tokens
            st["decode_tokens"] += raw.decode_tokens
            self._completed.append(comp)
            wl = comp.request.workload
            self._m_requests.inc(workload=wl, event="completed")
            self._m_tokens.inc(raw.prefill_tokens, workload=wl, kind="prefill")
            self._m_tokens.inc(raw.decode_tokens, workload=wl, kind="decode")
            self._attribute_energy(comp, raw.prefill_tokens + raw.decode_tokens)
            if comp._span is not None:
                comp._span.end(status="completed", steps=raw.steps,
                               decode_tokens=raw.decode_tokens)
        for key in [k for k, e in self._live.items()
                    if e.idle() and not self._groups.get(k)]:
            self._groups.pop(key, None)
            del self._live[key]

    # -- reporting ----------------------------------------------------------
    def _attribute_energy(self, comp: Completion, tokens: int) -> None:
        """Charge a completed request's modeled GEMM energy to its plan:
        per-token joules come from the plan's calibration envelope
        (``obs.plan_energy_per_token``). Plans without a document on disk
        (derived variants, loaders) attribute 0 — they carry no envelope."""
        if not comp.plan or tokens <= 0:
            return
        jpt = self._energy_per_token.get(comp.plan)
        if jpt is None:
            jpt = 0.0
            rp = self.router.get(comp.plan)
            if rp is not None and rp.path is not None:
                try:
                    from repro_torch.numerics import load_plan
                    jpt = plan_energy_per_token(load_plan(rp.path))
                except (OSError, ValueError, KeyError):
                    jpt = 0.0
            self._energy_per_token[comp.plan] = jpt
        if jpt:
            self._m_energy.inc(jpt * tokens, plan=comp.plan)

    def metrics(self) -> dict:
        """Request-accounting snapshot with a closed-sum invariant:
        ``submitted == routed + parked + rejected`` — every submitted request
        is exactly one of dispatched into an engine (``routed``), still
        queued in a group (``parked``), or rejected at admission. After a
        clean ``run()``, ``parked == 0`` and ``completed == routed``."""
        submitted = sum(st["submitted"] for st in self.stats_by_class.values())
        rejected = sum(st["rejected"] for st in self.stats_by_class.values())
        completed = sum(st["completed"] for st in self.stats_by_class.values())
        parked = self._queued()
        routed = len(self._inflight) + completed
        self._m_parked.set(float(parked))
        return {"submitted": submitted, "routed": routed, "parked": parked,
                "rejected": rejected, "completed": completed,
                "inflight": len(self._inflight),
                "energy_joules": self._m_energy.total(),
                "wall_seconds": self._wall}

    def stats(self) -> dict:
        """Per-class routing/latency/throughput plus pool bookkeeping."""
        classes = {}
        for wl, st in sorted(self.stats_by_class.items()):
            n = st["completed"]
            classes[wl] = {
                **{k: v for k, v in st.items() if k != "plans"},
                "plans": dict(st["plans"]),
                "mean_steps": st["steps"] / n if n else 0.0,
                "tokens_per_s": st["decode_tokens"] / self._wall if self._wall > 0 else 0.0,
            }
        return {"classes": classes, "pool": self.pool.stats(), "wall_seconds": self._wall}
