"""Continuous batching for the serving path (counterpart of
``repro.launch.batching``).

A slot-based scheduler in the vLLM style: the decode step runs for a fixed
(n_slots, max_len) cache; requests stream in and out of slots between steps
(host-side bookkeeping), and finished slots are refilled immediately, so the
decode batch never drains while work is queued.

The reference compiles the decode step once per engine (``jax.jit``). Here
one CUDA graph of the step is captured per engine and replayed at every
step: the step's few hundred kernels go to the card in one launch, with no
eager dispatch on the host. What the graph needs:

- the step reads no host value: the KV write cursor is a 0-d device tensor
  (``cache["len"]``), each slot's lower bound of attention a (n_slots,)
  device tensor (``cache["start"]``), and the step writes the cache in
  place (``models.decode_step``);
- static buffers: the tokens fed (n_slots, 1), the cursor, ``start`` and
  the logits' argmax (n_slots,). A step copies the host's tokens in,
  replays the graph and reads the argmax ids back, the one sync a step (the
  reference's ``np.asarray`` of its argmax);
- before the capture, two eager steps on a side stream build the kernels
  and fill every first-call cache (none of which may run inside a capture);
  the KV cache is then zeroed in place and the cursor rewound. The graph
  holds the cache's storage, so ``reset_cache`` zeroes in place where the
  reference reallocates.

The policy binds at capture, as the reference's binds at trace time, and
``capture_count`` (the reference's ``trace_count``) is 1 per engine. The
kernel wrappers count the launches that run in ``launches`` and those made
under a capture in ``captured``; a replay goes through no wrapper, so no
count grows with the replays. ``step_launches`` and ``step_dispatches``
record one step's kernel launches (the capture's ``captured``) and FDP
dispatches at capture; ``launches()`` derives the replays' launches from
them, ``step_launches`` times ``replays``, and writes no count.

A numerics monitor installed at capture (``obs.monitor``) records into
the graph: its reductions are captured with the step, and every replay
adds one call to its rows, with no read back to the host.

``graph=None`` means a graph on CUDA and eager steps on the CPU.
``graph=True`` on the CPU raises; a capture that fails raises, and never
falls back to eager steps. ``graph=False`` on CUDA runs eager steps only
when the caller asks for it (the eager twin of a graph engine).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.dispatch import NumericsPolicy, policy_from_plan, use_policy
from repro_torch.kernels import fdp_gemm as _k
from repro_torch.models import decode_step, init_cache


def _resolve_policy(policy) -> Optional[NumericsPolicy]:
    """Normalize the engine's numerics argument: a NumericsPolicy passes
    through, a PrecisionPlan deploys itself, a str/path loads a plan JSON."""
    if policy is None or isinstance(policy, NumericsPolicy):
        return policy
    if hasattr(policy, "to_policy"):               # PrecisionPlan duck-type
        return policy.to_policy()
    if isinstance(policy, (str, bytes)) or hasattr(policy, "__fspath__"):
        return policy_from_plan(policy)
    raise TypeError(
        f"policy must be a NumericsPolicy, PrecisionPlan, or plan path; "
        f"got {type(policy).__name__}")


def capture(body: Callable[[], torch.Tensor], policy_ctx, device, *,
            before: Optional[Callable[[], None]] = None):
    """Capture ``body()`` in one CUDA graph under ``policy_ctx()``: two
    eager calls on a side stream first (the kernels build and every
    first-call cache fills, none of which may run inside a capture), then
    ``before()`` (the batcher zeroes its KV and rewinds its cursor), then
    the capture. Returns (graph, body's output tensor, kernel launches
    recorded by the capture, FDP dispatches at capture by site key, the
    records of the capturable trace hooks). The hooks are told of each
    warm-up call and of the capture (``core.dispatch``, "Trace hooks"):
    the numerics monitor records nothing in the warm-up and captures its
    reductions with the body. Any other trace hook installed raises: it
    would run at capture only, never at replay."""
    hooks = dispatch.trace_hooks()
    if not all(getattr(h, "capturable", False) for h in hooks):
        raise RuntimeError("a dispatch trace hook that cannot be captured is installed: "
                           "a captured step would call it at capture only, never at replay")
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with policy_ctx(), torch.cuda.stream(side):
        for _ in range(2):
            with contextlib.ExitStack() as stack:
                for h in hooks:
                    stack.enter_context(h.warmup())
                body()
    torch.cuda.current_stream(device).wait_stream(side)
    if before is not None:
        before()
    captured = {n: w.captured for n, w in _k.KERNELS.items()}
    calls = dispatch.site_calls()
    graph = torch.cuda.CUDAGraph()
    with contextlib.ExitStack() as stack:
        records = [stack.enter_context(h.capture()) for h in hooks]
        with policy_ctx(), torch.cuda.graph(graph):
            out = body()
            for rec in records:
                rec.seal()
    launches = {n: w.captured - captured[n] for n, w in _k.KERNELS.items()
                if w.captured != captured[n]}
    dispatches = {s: c - calls.get(s, 0) for s, c in dispatch.site_calls().items()
                  if c != calls.get(s, 0)}
    return graph, out, launches, dispatches, records


class CacheExhausted(RuntimeError):
    """The engine's global KV write cursor can no longer fit any queued
    request. The cursor is shared across slots and never rewinds, so once
    the queue head's ``prompt + max_new`` exceeds ``cache_remaining()``
    nothing will ever be admitted again — call ``reset_cache()`` between
    drained generations."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list              # token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # scheduling evidence, recorded by ContinuousBatcher.step: how many
    # engine steps this request was live in, and how its token budget split
    # between prefill (prompt tokens fed) and decode (tokens generated)
    steps: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    # streaming hook: called with each freshly decoded token id, from inside
    # the engine step that produced it
    on_token: Optional[Callable[[int], None]] = None


class ContinuousBatcher:
    """Fixed-slot continuous batching engine.

    The cache is allocated for n_slots sequences of max_len. Prompt tokens
    are fed through the same decode step (one token per step per slot —
    chunked prefill); slots whose request finished are re-assigned without
    capturing anything again.
    """

    def __init__(self, cfg, params, n_slots: int = 4, max_len: int = 128, *,
                 eos_id: Optional[int] = None,
                 warmup: Union[bool, NumericsPolicy, str, object] = False,
                 policy=None, graph: Optional[bool] = None):
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_len = n_slots, max_len
        self.eos_id = eos_id
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError("continuous batching engine supports KV-cache families")
        # ``warmup`` doubles as the numerics argument: passing a
        # NumericsPolicy / PrecisionPlan / plan path both installs the policy
        # AND warms up under it (the common plan-serving call shape).
        if not isinstance(warmup, bool):
            if policy is not None:
                raise TypeError(
                    "pass the numerics either as warmup=<plan/policy> or as "
                    "policy=..., not both — silently preferring one would "
                    "bake the other's formats out of the captured step")
            policy = warmup
            warmup = True
        self.policy = _resolve_policy(policy)
        dev = params.embed.device
        if graph is None:
            graph = dev.type == "cuda"
        if graph and dev.type != "cuda":
            raise ValueError(f"graph=True needs the parameters on a CUDA device, "
                             f"not {dev}")
        self.device, self.graphed = dev, graph
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * n_slots
        # per-slot progress: how many prompt tokens already fed
        self._fed = np.zeros(n_slots, dtype=np.int64)
        # the write cursor cache["len"] is global; each slot masks its
        # attention to [start[slot], len) so reused slots never see the
        # previous occupant's KV. ``_len`` and ``_start`` mirror them on the
        # host so admission control never reads the device.
        self._len = 0
        self._start = np.zeros(n_slots, dtype=np.int64)
        self.cache = init_cache(cfg, n_slots, max_len, dtype=torch.float32, device=dev)
        self.cache["len"] = torch.zeros((), dtype=torch.int64, device=dev)
        self.cache["start"] = torch.zeros(n_slots, dtype=torch.int64, device=dev)
        self._tokens = torch.zeros((n_slots, 1), dtype=torch.int64, device=dev)
        pin = dev.type == "cuda"
        self._tokens_host = torch.zeros((n_slots, 1), dtype=torch.int64, pin_memory=pin)
        self._start_host = torch.zeros(n_slots, dtype=torch.int64, pin_memory=pin)
        self._graph = None
        self._next = None                  # the graph's argmax ids (n_slots,)
        self._records: list = []           # the capturable hooks' records
        # captured exactly once per graph engine — the regression guard for
        # "the policy binds at capture"
        self.capture_count = 0
        self.replays = 0
        self.step_launches: dict = {}      # kernel name -> launches a step
        self.step_dispatches: dict = {}    # site key -> dispatches a step
        if warmup and graph:
            # Capture the decode step before the first request arrives,
            # under the serving policy: dispatch looks each site up while
            # the step is captured, so a capture under the wrong policy
            # would bake the wrong formats into every replay.
            self._capture()

    def _policy_ctx(self):
        return use_policy(self.policy) if self.policy is not None \
            else contextlib.nullcontext()

    def _step_body(self) -> torch.Tensor:
        """One decode step on the static buffers: writes the KV at the
        cursor, advances it, returns the argmax ids (n_slots,)."""
        logits, _ = decode_step(self.params, self.cfg, self.cache, self._tokens)
        self.cache["len"].add_(1)
        return torch.argmax(logits[:, 0, :self.cfg.vocab_size], dim=-1)

    def _zero_state(self) -> None:
        for t in self.cache["layers"].values():
            t.zero_()
        self.cache["len"].zero_()

    def _capture(self) -> None:
        if self._graph is not None:
            raise RuntimeError("the decode step is already captured")
        (self._graph, self._next, self.step_launches, self.step_dispatches,
         self._records) = capture(self._step_body, self._policy_ctx, self.device,
                                  before=self._zero_state)
        self.capture_count += 1

    def launches(self) -> dict:
        """Kernel launches of this engine's replays, derived: the launches a
        step captured times ``replays`` (empty without a graph, whose eager
        steps the wrappers count themselves). A replay goes through no
        wrapper, so this is not a count; a profiler trace of the replays
        measures it."""
        return {n: k * self.replays for n, k in self.step_launches.items()}

    def cache_remaining(self) -> int:
        """Writable KV positions left before the global write cursor hits the
        cache wall. The cursor advances one position per engine step (shared
        by every slot) and never rewinds, so this is the budget any newly
        admitted request's ``prompt + max_new`` must fit inside."""
        return max(0, self.max_len - 1 - self._len)

    def reset_cache(self) -> None:
        """Reclaim KV room without capturing again: zero the cache in place
        (the graph holds its storage) and rewind the cursor. Only legal
        while no slot is live (a live slot's KV would be destroyed
        mid-generation)."""
        if any(r is not None for r in self.active):
            raise RuntimeError("reset_cache with live slots would destroy "
                               "in-flight generations; drain first")
        self._zero_state()
        self._len = 0
        self._start[:] = 0
        self.cache["start"].zero_()

    def stats(self):
        """Typed ``PlanCacheStats`` for the process-global GemmPlan cache, a
        view over the ``repro_torch.obs`` registry
        (``repro_plan_cache_ops_total`` / ``repro_plan_cache_size``)."""
        return dispatch.plan_cache_stats()

    def numerics_info(self) -> dict:
        """GemmPlan cache + call-site report for this engine's decode step
        (introspection: what the dispatch layer planned for serving)."""
        return {"plans": self.stats().as_dict(),
                "sites": sorted(dispatch.sites_seen()),
                "policy": self.policy.name if self.policy else None}

    def submit(self, req: Request):
        self.queue.append(req)

    def _fill_slots(self):
        changed = False
        for i in range(self.n_slots):
            if self.active[i] is None and self.queue:
                head = self.queue[0]
                if len(head.prompt) + head.max_new > self.cache_remaining():
                    # the cursor has outrun the cache: admitting this request
                    # would silently truncate its generation. Refuse the slot
                    # and leave it queued — FIFO, so later smaller requests
                    # never starve the head.
                    break
                self.active[i] = self.queue.popleft()
                self._fed[i] = 0
                self._start[i] = self._len
                changed = True
        if changed:
            self._start_host.numpy()[:] = self._start
            self.cache["start"].copy_(self._start_host, non_blocking=True)

    def _next_tokens(self):
        toks = self._tokens_host.numpy()
        toks[:] = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if self._fed[i] < len(req.prompt):        # still prefilling
                toks[i, 0] = req.prompt[self._fed[i]]
            elif req.out:
                toks[i, 0] = req.out[-1]
            else:
                toks[i, 0] = req.prompt[-1]
        self._tokens.copy_(self._tokens_host, non_blocking=True)

    def _decode(self) -> list:
        """Run the step on the static buffers; the argmax id of each slot."""
        if self.graphed:
            if self._graph is None:
                # non-warmed engines capture lazily on the first step, under
                # the same numerics the warmup path captures with
                self._capture()
            self._graph.replay()
            self.replays += 1
            return self._next.tolist()
        with self._policy_ctx():
            return self._step_body().tolist()

    def step(self):
        """One engine step: feed one token per active slot."""
        self._fill_slots()
        if all(r is None for r in self.active):
            return False
        self._next_tokens()
        nxt = self._decode()
        self._len += 1
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self._fed[i] += 1
            req.steps += 1
            if self._fed[i] <= len(req.prompt):
                req.prefill_tokens += 1          # this step fed a prompt token
            if self._fed[i] < len(req.prompt):
                continue                                # still prefilling
            req.out.append(int(nxt[i]))
            req.decode_tokens += 1
            if req.on_token is not None:
                req.on_token(req.out[-1])
            hit_eos = self.eos_id is not None and req.out[-1] == self.eos_id
            # the cursor wall: the next feed would write past the cache.
            # Admission control (cache_remaining) guarantees this never fires
            # for admitted requests; it stays as the last-ditch guard.
            at_wall = self._len >= self.max_len - 1
            if len(req.out) >= req.max_new or hit_eos or at_wall:
                req.done = True
                self.active[i] = None                   # slot freed
        return True

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until the queue and all slots drain (or max_steps).

        Raises ``CacheExhausted`` when the queue is non-empty but nothing can
        ever be admitted (the global cursor has outrun the cache) — loud
        refusal instead of silent truncation."""
        from repro_torch.obs.spans import span
        with span("serving.batcher_run", n_slots=self.n_slots,
                  max_len=self.max_len) as sp:
            steps = 0
            for _ in range(max_steps):
                if not self.step():
                    if self.queue:
                        head = self.queue[0]
                        raise CacheExhausted(
                            f"{len(self.queue)} queued request(s) can no "
                            f"longer fit: head needs "
                            f"{len(head.prompt) + head.max_new} positions, "
                            f"cache_remaining()={self.cache_remaining()} "
                            f"of max_len={self.max_len}")
                    break
                steps += 1
            sp.annotate(steps=steps)


def serve_requests(cfg, params, requests: list[Request], n_slots: int = 4,
                   max_len: int = 128, warmup=False, policy=None) -> list[Request]:
    """Convenience: run a list of requests to completion."""
    eng = ContinuousBatcher(cfg, params, n_slots, max_len, warmup=warmup,
                            policy=policy)
    for r in requests:
        eng.submit(r)
    eng.run()
    return requests
