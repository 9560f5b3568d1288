"""Bucketed engine pool — the saxml ``ServableMethod`` shape (counterpart of
``repro.serving.engine``).

A small *sorted* table of (batch-slots, sequence-length) **buckets**,
per-(plan, bucket, method) engines created **lazily** on first traffic,
padded-shape dispatch to the smallest fitting bucket, and **LRU eviction**
of idle engines under a live-engine cap, so the pool's device footprint
stays bounded however many plans the router serves.

Methods (the saxml trio):
    ``generate`` - fixed-slot continuous batching (``ContinuousBatcher``)
    ``stream``   - the same engine, tokens delivered through per-request
                   ``on_token`` callbacks as each decode step lands
    ``score``    - teacher-forced log-probability of the prompt, one padded
                   whole-batch forward per bucket

Where the reference compiles each engine once (``jax.jit``), an engine here
captures one CUDA graph on the card, under its plan's ``NumericsPolicy``
(numerics bind at capture): the batcher's decode step, or the score
engine's padded forward, log-softmax, gather and masked sum on static
token and mask buffers. ``capture_count`` (the reference's
``trace_count``) is 1 for a graph engine however many calls it serves, and
0 for an eager one. ``graph=None`` means graphs on CUDA and eager steps on
the CPU, with or without the numerics monitor: an engine built while it is
installed captures the monitor's reductions with its step, and every
replay is recorded (``obs.monitor``). A capture that fails raises; no
engine falls back to eager steps. An evicted engine drops its graph, its
private memory pool and its KV cache with it, and a later request for the
same key captures again (``compiles`` counts it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence, Union

import torch

from repro_torch.core import dispatch
from repro_torch.core.dispatch import NumericsPolicy, use_policy
from repro_torch.launch.batching import ContinuousBatcher, Request, capture
from repro_torch.models import forward
from repro_torch.obs.registry import default_registry
from repro_torch.obs.spans import span

METHODS = ("score", "generate", "stream")


class AdmissionError(RuntimeError):
    """The request can never be served by this pool/frontend: no bucket fits
    its ``prompt + max_new``, or the queue is at its backpressure cap."""


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One (slots, padded sequence length) serving shape. Ordering is by
    sequence capacity first — ``bucket_for`` picks the smallest fit."""

    max_len: int
    n_slots: int

    def __post_init__(self):
        if self.n_slots < 1 or self.max_len < 4:
            raise ValueError(f"degenerate bucket {self.label}")

    @property
    def label(self) -> str:
        return f"{self.n_slots}x{self.max_len}"

    @property
    def capacity(self) -> int:
        """Positions a request may consume (the engine keeps one sentinel)."""
        return self.max_len - 1


def parse_buckets(spec: str) -> tuple:
    """``"2x32,4x64"`` -> sorted (Bucket(32,2), Bucket(64,4)). The textual
    order is slots x len (the saxml batch-size-table convention)."""
    buckets = []
    for part in spec.split(","):
        ns, _, ml = part.strip().partition("x")
        buckets.append(Bucket(max_len=int(ml), n_slots=int(ns)))
    return tuple(sorted(set(buckets)))


class GenerateEngine:
    """A ``ContinuousBatcher`` bound to one (plan, bucket): the ``generate``
    and ``stream`` methods. Streaming is the same step — tokens leave through
    ``Request.on_token`` as they land."""

    def __init__(self, cfg, params, bucket: Bucket, policy: Optional[NumericsPolicy],
                 method: str, eos_id: Optional[int] = None, graph: Optional[bool] = None):
        self.bucket, self.method = bucket, method
        self.batcher = ContinuousBatcher(
            cfg, params, n_slots=bucket.n_slots, max_len=bucket.max_len, eos_id=eos_id,
            warmup=policy if policy is not None else True, graph=graph)

    @property
    def capture_count(self) -> int:
        return self.batcher.capture_count

    @property
    def step_launches(self) -> dict:
        return self.batcher.step_launches

    @property
    def step_dispatches(self) -> dict:
        return self.batcher.step_dispatches

    def idle(self) -> bool:
        return not self.batcher.queue and all(r is None for r in self.batcher.active)

    def cache_remaining(self) -> int:
        return self.batcher.cache_remaining()

    def recycle_if_exhausted(self, need: int) -> None:
        """Fresh KV room for a request needing ``need`` positions — only
        possible while drained; the captured step survives the reset."""
        if self.idle() and self.batcher.cache_remaining() < need:
            self.batcher.reset_cache()

    def admit(self, req: Request) -> None:
        self.batcher.submit(req)

    def step(self) -> bool:
        return self.batcher.step()


class ScoreEngine:
    """Teacher-forced prompt log-probability at the bucket shape: one padded
    (n_slots, max_len) forward, per-row masked sum of next-token log-probs.
    On CUDA the whole computation is one CUDA graph on static token and mask
    buffers, captured under ``policy`` (``step_launches`` and
    ``step_dispatches`` are a call's, recorded at capture); on the CPU it
    runs eager."""

    def __init__(self, cfg, params, bucket: Bucket, policy: Optional[NumericsPolicy],
                 graph: Optional[bool] = None):
        self.cfg, self.params = cfg, params
        self.bucket = bucket
        self.method = "score"
        self.policy = policy
        dev = params.embed.device
        if graph is None:
            graph = dev.type == "cuda"
        if graph and dev.type != "cuda":
            raise ValueError(f"graph=True needs the parameters on a CUDA device, not {dev}")
        shape = (bucket.n_slots, bucket.max_len)
        self._tokens = torch.zeros(shape, dtype=torch.int64, device=dev)
        self._mask = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.capture_count = 0
        self.step_launches: dict = {}
        self.step_dispatches: dict = {}
        self._graph = self._out = None
        self._records: list = []
        if graph:
            (self._graph, self._out, self.step_launches, self.step_dispatches,
             self._records) = capture(self._body, self._policy_ctx, dev)
            self.capture_count += 1

    def _policy_ctx(self):
        return use_policy(self.policy) if self.policy is not None \
            else contextlib.nullcontext()

    @torch.inference_mode()
    def _body(self) -> torch.Tensor:
        tokens, cfg = self._tokens, self.cfg
        batch = {"tokens": tokens}
        n, dev = tokens.shape[0], tokens.device
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((n, cfg.n_patches, cfg.d_model), device=dev)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((n, cfg.enc_seq, cfg.d_model), device=dev)
        logits = forward(self.params, cfg, batch, remat="none")
        # the text positions (vlm places the patches ahead of them)
        logp = torch.log_softmax(logits[:, -tokens.shape[1]:, :cfg.vocab_size], dim=-1)
        lp = torch.gather(logp[:, :-1], -1, tokens[:, 1:, None])[..., 0]
        return torch.sum(lp * self._mask[:, 1:], dim=-1)

    def idle(self) -> bool:
        return True                          # one-shot: no resident state

    def score_batch(self, prompts: Sequence[Sequence[int]]) -> list:
        """Score up to ``n_slots`` prompts in one padded call (one replay on
        the card)."""
        if len(prompts) > self.bucket.n_slots:
            raise ValueError(f"{len(prompts)} prompts > bucket {self.bucket.label}")
        shape = (self.bucket.n_slots, self.bucket.max_len)
        toks = torch.zeros(shape, dtype=torch.int64)
        mask = torch.zeros(shape, dtype=torch.float32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = torch.as_tensor(p, dtype=torch.int64)
            mask[i, :len(p)] = 1.0
        self._tokens.copy_(toks)
        self._mask.copy_(mask)
        if self._graph is not None:
            self._graph.replay()
            out = self._out
        else:
            with self._policy_ctx():
                out = self._body()
        out = out.tolist()
        return [float(out[i]) for i in range(len(prompts))]


class BucketedEnginePool:
    """Lazy (plan, bucket, method) -> engine cache with LRU eviction.

    ``max_live`` bounds resident engines; eviction only takes *idle* engines
    (a live engine holds in-flight KV state), so the pool may transiently
    exceed the cap when every engine is mid-generation — it shrinks back on
    the next miss. ``graph`` goes to every engine (module docstring).
    ``stats()``: compiles (captures on the card)/hits/evictions plus
    per-bucket dispatch counts (the bucket hit rate)."""

    def __init__(self, cfg, params, buckets: Union[str, Sequence[Bucket]],
                 max_live: int = 4, eos_id: Optional[int] = None,
                 graph: Optional[bool] = None):
        if isinstance(buckets, str):
            buckets = parse_buckets(buckets)
        self.buckets = tuple(sorted(set(buckets)))
        if not self.buckets:
            raise ValueError("pool needs at least one bucket")
        dev = params.embed.device
        if graph and dev.type != "cuda":
            raise ValueError(f"graph=True needs the parameters on a CUDA device, not {dev}")
        self.cfg, self.params, self.eos_id = cfg, params, eos_id
        self.max_live = max_live
        self.graph = graph
        self._engines: OrderedDict = OrderedDict()
        self._stats = {"compiles": 0, "hits": 0, "evictions": 0}
        self._bucket_hits: dict = {b.label: 0 for b in self.buckets}
        # process-wide mirror of the per-instance counters (the dicts above
        # stay this pool's exact source of truth)
        self._m_ops = default_registry().counter(
            "repro_engine_pool_ops_total", "bucketed engine pool events", ("op",))
        self._m_resident = default_registry().gauge(
            "repro_engine_pool_resident", "engines resident in the pool")

    def bucket_for(self, prompt_len: int, max_new: int) -> Bucket:
        """Smallest bucket whose capacity fits ``prompt + max_new`` (padded
        dispatch: the request runs at the bucket shape, reusing its engine)."""
        need = prompt_len + max_new
        for b in self.buckets:
            if need <= b.capacity:
                return b
        raise AdmissionError(
            f"request needs {need} positions; largest bucket is "
            f"{self.buckets[-1].label} (capacity {self.buckets[-1].capacity})")

    def get(self, plan, bucket: Bucket, method: str):
        """The engine for (plan, bucket, method), built (and on the card
        captured) on first use. ``plan`` is a ``RoutedPlan`` (anything with
        ``.name``/``.policy()``)."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; have {METHODS}")
        if bucket not in self.buckets:
            raise ValueError(f"bucket {bucket.label} not in this pool")
        key = (plan.name, bucket, method)
        eng = self._engines.get(key)
        if eng is not None:
            self._engines.move_to_end(key)
            self._stats["hits"] += 1
            self._m_ops.inc(op="hits")
            self._bucket_hits[bucket.label] += 1
            return eng
        self._evict_idle()
        policy = plan.policy()
        with span("serving.aot_compile", plan=plan.name, bucket=bucket.label, method=method):
            if method == "score":
                eng = ScoreEngine(self.cfg, self.params, bucket, policy, graph=self.graph)
            else:
                eng = GenerateEngine(self.cfg, self.params, bucket, policy, method,
                                     eos_id=self.eos_id, graph=self.graph)
        self._engines[key] = eng
        self._stats["compiles"] += 1
        self._m_ops.inc(op="compiles")
        self._m_resident.set(float(len(self._engines)))
        self._bucket_hits[bucket.label] += 1
        return eng

    def _evict_idle(self) -> None:
        """Drop least-recently-used *idle* engines until under the cap."""
        while len(self._engines) >= self.max_live:
            victim = next((k for k, e in self._engines.items() if e.idle()), None)
            if victim is None:
                return                       # everything is mid-generation
            del self._engines[victim]
            self._stats["evictions"] += 1
            self._m_ops.inc(op="evictions")
            self._m_resident.set(float(len(self._engines)))

    def live(self) -> dict:
        return dict(self._engines)

    def stats(self) -> dict:
        """Per-instance pool bookkeeping (exact counts for this pool; the
        process-wide scrape surface is the ``repro_torch.obs`` registry:
        ``repro_engine_pool_ops_total`` / ``repro_engine_pool_resident``)."""
        total = sum(self._bucket_hits.values())
        return {**self._stats, "resident": len(self._engines),
                "bucket_hits": dict(self._bucket_hits),
                "bucket_hit_rate": self._stats["hits"] / total if total else 0.0,
                # GemmPlan cache counters (process-global)
                "plans": dispatch.plan_cache_stats().as_dict()}
