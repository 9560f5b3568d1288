"""Serve a mixed workload trace through the routed serving tier (counterpart
of ``python -m repro.serving``).

On the card:
    PYTHONPATH=src python -m repro_torch.serving --arch paper-mlp \
        --requests 12 --buckets 2x32,4x64 --max-live 2
On the CPU at test size: add ``--reduced --device cpu``.

Builds the architecture, loads the plan zoo's MANIFEST for it (with the
derived fdp91/repro variants), synthesizes a mixed trace — chat (generate),
solve (generate under wide numerics), repro (bit-stable generate), a
streamed request and a score request — serves it through ``RoutedFrontend``,
and prints per-class routing/latency stats plus the engine pool's
capture/eviction/bucket-hit bookkeeping. Prompts are drawn from a CPU
``torch.Generator(seed + 1)``, where the reference draws from
``jax.random``: the two CLIs serve different prompts.

``--require-complete`` exits nonzero if any request failed or was rejected.

Observability flags: ``--monitor`` serves under a live calibration-envelope
monitor (the base zoo plan's envelope; the pool's engines are captured with
its reductions inside their CUDA graphs, so every replay is recorded),
``--metrics-dump out.json`` writes the registry + monitor +
request-accounting snapshot (implies ``--monitor``), ``--inject-violation
SITE`` fires one deliberately out-of-envelope GEMM at the named plan site
after the trace drains, ``--trace-out trace.json`` exports the span
timeline as Chrome-trace JSON.

The GEMM schedules of the device's backend are preloaded first
(``core.schedules``; the port's zoo is ``src/repro_torch/schedules/``, where
the reference reads ``<plans>/schedules``), and their count printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.schedules import preload_schedules
from repro_torch.device import resolve_device
from repro_torch.models import init
from repro_torch.serving import (BucketedEnginePool, PlanRouter, RoutedFrontend,
                                 ServeRequest, parse_buckets)

CLASS_CYCLE = ("chat", "solve", "repro")


def build_trace(gen: torch.Generator, vocab: int, n: int, max_new: int) -> list:
    """A deterministic mixed trace: classes round-robin over varied prompt
    lengths; one streamed request and one score request ride along."""
    reqs = []
    for i in range(n):
        wl = CLASS_CYCLE[i % len(CLASS_CYCLE)]
        plen = 3 + (i * 5) % 11
        prompt = torch.randint(0, vocab, (plen,), generator=gen).tolist()
        method = "generate"
        if i == 1:
            method = "stream"
        elif i == 2:
            method = "score"
        reqs.append(ServeRequest(uid=i, prompt=prompt, max_new=max_new, workload=wl,
                                 method=method))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-mlp")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions, eager engines)")
    ap.add_argument("--plans", default="examples/plans",
                    help="plan zoo directory (MANIFEST.json inside)")
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--buckets", default="2x32,4x64")
    ap.add_argument("--max-live", type=int, default=2,
                    help="max concurrently live decode batches (backpressure)")
    ap.add_argument("--max-engines", type=int, default=6,
                    help="resident-engine cap for the LRU pool")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also dump the stats dict to this path")
    ap.add_argument("--require-complete", action="store_true",
                    help="exit 1 unless every request completed (CI gate)")
    ap.add_argument("--monitor", action="store_true",
                    help="serve under live calibration-envelope monitors")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write registry+monitor+serving snapshot JSON (implies --monitor)")
    ap.add_argument("--inject-violation", default=None, metavar="SITE",
                    help="after serving, dispatch one out-of-envelope GEMM at SITE "
                         "(implies --monitor)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export span timeline as Chrome-trace JSON")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n_sched = preload_schedules(backend=dev.type)
    cfg = get_config(args.arch)
    # plans are recorded per base arch; the reduced config only shrinks shapes
    router = PlanRouter.from_manifest(args.plans, arch=cfg.name)
    if args.reduced:
        cfg = cfg.reduced()
    params = init(cfg, seed=args.seed, device=dev)

    monitor_on = bool(args.monitor or args.metrics_dump or args.inject_violation)
    mon_ctx, plan_doc = contextlib.nullcontext(None), None
    if monitor_on:
        from repro_torch.numerics import load_plan
        from repro_torch.obs import monitoring
        base = next((p for p in router.plans if p.derived is None and p.path), None)
        if base is None:
            print("[repro_torch.serving] no zoo plan with a document on disk — "
                  "cannot monitor", file=sys.stderr)
            sys.exit(2)
        plan_doc = load_plan(base.path)
        mon_ctx = monitoring(plan_doc)

    with mon_ctx as mon:
        pool = BucketedEnginePool(cfg, params, parse_buckets(args.buckets),
                                  max_live=args.max_engines)
        front = RoutedFrontend(pool, router, max_live_batches=args.max_live)

        streamed: list = []
        reqs = build_trace(torch.Generator().manual_seed(args.seed + 1), cfg.vocab_size,
                           args.requests, args.max_new)
        for r in reqs:
            if r.method == "stream":
                r.on_token = streamed.append
        comps = [front.submit(r) for r in reqs]
        front.run()

        if args.inject_violation:
            _inject_violation(args.inject_violation, plan_doc, dev)

    stats = front.stats()
    print(f"[repro_torch.serving] {cfg.name}: {len(reqs)} requests, "
          f"buckets={args.buckets}, max_live={args.max_live}, device={dev}")
    if monitor_on:
        graphs = sum(e.capture_count for e in pool.live().values())
        print(f"  engines captured with the monitor's reductions inside ({graphs} CUDA "
              f"graphs resident; eager steps on the CPU)")
    for wl, st in stats["classes"].items():
        plans = ", ".join(f"{p} x{n}" for p, n in sorted(st["plans"].items()))
        print(f"  {wl:8s} {st['completed']}/{st['submitted']} ok "
              f"({st['rejected']} rejected)  mean_steps={st['mean_steps']:.1f}"
              f"  decode_toks={st['decode_tokens']}"
              f"  tok/s={st['tokens_per_s']:.1f}  -> {plans}")
    pool_st = stats["pool"]
    print(f"  pool: {pool_st['compiles']} compiles, {pool_st['hits']} hits, "
          f"{pool_st['evictions']} evictions, resident={pool_st['resident']},"
          f" bucket_hits={pool_st['bucket_hits']}")
    ps = pool_st["plans"]
    print(f"  plans: {n_sched} preloaded from zoo; cache size={ps['size']} "
          f"hits={ps['hits']} misses={ps['misses']} "
          f"autotuned={ps['autotuned']} persisted={ps['persisted_loads']}")
    if streamed:
        print(f"  streamed uid=1: {streamed}")
    if mon is not None:
        print(f"  monitor: worst={mon.worst_status()} over {len(mon.statuses())} sites, "
              f"overflow_events={mon.overflow_events()}")

    failures = [c for c in comps if not c.ok]
    for c in failures:
        print(f"  FAILED uid={c.request.uid} class={c.request.workload}: {c.error}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True, default=str)
    if args.metrics_dump:
        from repro_torch.obs.registry import default_registry
        dump = {"kind": "repro.obs.ServingMetricsDump", "version": 1, "arch": cfg.name,
                "metrics": default_registry().snapshot(),
                "monitor": mon.snapshot() if mon is not None else None,
                "serving": front.metrics()}
        with open(args.metrics_dump, "w") as f:
            json.dump(dump, f, indent=1, sort_keys=True, default=str)
        print(f"  metrics dump -> {args.metrics_dump}")
    if args.trace_out:
        from repro_torch.obs.export import save_chrome_trace
        n_ev = save_chrome_trace(args.trace_out)
        print(f"  chrome trace ({n_ev} events) -> {args.trace_out}")
    if args.require_complete and failures:
        sys.exit(1)


def _inject_violation(site: str, plan_doc, dev) -> None:
    """One deliberately out-of-envelope dispatch at ``site`` under the
    deployed plan's policy: operands at 2^70 push the product past every
    traced exponent range (and past f32 overflow → a non-finite event), so
    the monitor must flip exactly this site to ``violated``."""
    from repro_torch.core import dispatch
    dispatch.gemm(torch.full((8, 16), 2.0 ** 70, device=dev),
                  torch.full((16, 8), 2.0 ** 70, device=dev),
                  site=site, policy=plan_doc.to_policy())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"  injected out-of-envelope dispatch at site {site!r}")


if __name__ == "__main__":
    main()
