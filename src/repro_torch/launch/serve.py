"""Batched serving entry point (counterpart of ``repro.launch.serve``):
prefill + greedy incremental decode with an f32 KV cache (an f32 conv and
SSM state cache for the Mamba-2 layers of ``ssm`` and ``hybrid`` models;
the encoder's cross K/V too for ``encdec``). As in the reference, ``serve``
gives an encdec model zero ``frames`` and a vlm model zero ``patches``
(which its prefill does not read).

On the card, under the FDP kernel policy:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --policy fdp91_kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --policy fdp91_kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
        --policy fdp91_kernel
On the CPU at test size (any architecture, e.g. dbrx-132b, mamba2-1.3b,
zamba2-2.7b, whisper-large-v3 or paligemma-3b):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
        --reduced --device cpu

Under a precision plan (per-site numerics loaded from JSON):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --precision-plan examples/plans/qwen3_0p6b.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --precision-plan examples/plans/zamba2_2p7b.json

``--policy`` picks one of the named uniform policies instead; passing both
is an error, so that it is never unclear which policy served.

On a mesh (``--mesh RxC --profile {fsdp,ddp,decode_tp}``, ``--engine
simple`` only, as in the reference; ``--profile`` defaults to
``decode_tp``): where the reference runs one process over many devices,
the port spawns R*C ranks on ``--device`` (``launch.mesh.spawn``: gloo
where the ranks share a card or run on the CPU, NCCL where each rank has a
card of its own). Each rank builds ``make_mesh``, ``distribution_for(profile,
policy)`` and the placed ``init(..., profile=)``: it holds its block of every
weight (``launch.sharding.param_specs``) and gathers each unit's leaves on
use. Every rank serves through ``serve(dist=)``; rank 0 prints the usual
line, the mesh, the profile, each rank's placed bytes and the bytes
gathered a decode step (``prefill`` runs one a prompt token). On the CPU,
a gloo world of CPU ranks:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --reduced --device cpu --mesh 2x2 --profile fsdp
On the card (four ranks sharing it over gloo):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --reduced --policy fdp91_kernel --mesh 2x2 --profile fsdp

``--engine continuous`` (KV-cache families only, as in the reference: the
SSM, hybrid and encdec families serve on the simple engine) routes the same
requests through the fixed-slot
``launch.batching.ContinuousBatcher``: one request a prompt row, a cache of
``prompt_len + 2 * gen + 2`` positions, the decode step captured in one CUDA
graph under the policy before the first request arrives (on the CPU: eager
steps). ``--engine routed`` goes through the serving tier
(``repro_torch.serving``): the plan zoo's MANIFEST picks each request's
numerics by workload class (``--workload``, or an explicit plan name), a
bucketed engine pool (one CUDA graph an engine on the card) serves it, and
per-class routing/latency stats print at the end.

Observability: ``--monitor`` serves under a live calibration-envelope
monitor (``obs.monitor``; the envelope of ``--precision-plan`` or, routed,
of the architecture's zoo plan). The continuous and routed engines are
captured with the monitor's reductions inside their CUDA graphs, so every
replay is recorded (on the CPU they run eager steps, as without it; the
simple engine runs eager anyway).
``--metrics-dump``, ``--metrics-port``/``--metrics-hold`` and
``--trace-out`` write the registry, serve it over HTTP, and export the span
timeline.

At startup the plan cache is preloaded from the schedule zoo of the
device's backend (``core.schedules``: ``src/repro_torch/schedules/cuda.json``
on the card), so the dense kernel launches the layouts measured there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import (FDP91, MXU_BF16, MXU_FP32, GemmConfig,
                                       NumericsPolicy, policy_from_plan, use_policy)
from repro_torch.core.formats import FP32
from repro_torch.core.schedules import preload_schedules
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import PROFILES, distribution_for, make_mesh, parse_mesh
from repro_torch.models import LOCAL, decode_step, init, init_cache, prefill
from repro_torch.models.transformer import block_of, gather_block, init_abstract
from repro_torch.parallel.placement import STATS, placed_bytes

# Every site through the hand-written FDP GEMM kernel at the paper's
# <30,30,-30> 91-bit accumulator (FDP91's numerics in ``pallas`` mode).
FDP91_KERNEL = NumericsPolicy(
    GemmConfig(FP32, AccumulatorSpec.paper_91bit(), "pallas"), name="fdp91_kernel")
POLICIES = {p.name: p for p in (MXU_BF16, MXU_FP32, FDP91, FDP91_KERNEL)}
# a --mesh world: the whole serve, and one collective (a gather of a unit
# over gloo, host-staged where ranks share a card)
MESH_TIMEOUT_S, MESH_COLLECTIVE_TIMEOUT_S = 3600.0, 600.0


def policy_from_args(args) -> NumericsPolicy:
    """The policy of ``--policy`` or ``--precision-plan`` (passing both is an
    error); ``MXU_BF16`` when neither is given."""
    if args.precision_plan and args.policy:
        raise SystemExit("pass --policy or --precision-plan, not both")
    if args.precision_plan:
        return policy_from_plan(args.precision_plan)
    return POLICIES[args.policy or MXU_BF16.name]


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None or t.device.index == dev.index)


@torch.inference_mode()
def serve(cfg, params, prompts, gen_len: int, device=None, dist=LOCAL) -> torch.Tensor:
    """prompts: (B, S) int. Greedy decode gen_len tokens. Returns (B, gen)
    int64 on ``device`` (CUDA unless the caller asks for another). On a mesh
    (``dist``, the experts the rank's slices) every rank serves its rows
    (``transformer.block_of``) and returns the global tokens."""
    dev = resolve_device(device)
    if not _on(params.embed, dev):
        raise ValueError(f"params are on {params.embed.device}, serving on {dev}")
    prompts = torch.as_tensor(prompts, device=dev)
    B, S = prompts.shape
    rows = block_of(dist, B, 1)[0]
    cache = init_cache(cfg, rows.stop - rows.start, max_len=S + gen_len,
                       dtype=torch.float32, device=dev)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((B, cfg.n_patches, cfg.d_model), device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.enc_seq, cfg.d_model), device=dev)
    last_logits, cache = prefill(params, cfg, batch, cache, dist)
    out = []
    tok = torch.argmax(last_logits, dim=-1)[:, None]
    for _ in range(gen_len):
        out.append(tok)
        logits, cache = decode_step(params, cfg, cache, tok, dist)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
    return gather_block(torch.cat(out, dim=1), dist, 1)


def _zoo_envelope(plans_dir: str, arch: str):
    """The calibration envelope of ``arch``'s first zoo plan in the MANIFEST
    (None without one)."""
    from repro_torch.numerics import load_plan
    with open(os.path.join(plans_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for key, entry in sorted(manifest.get("plans", {}).items()):
        if arch in (key, entry.get("arch")):
            path = os.path.join(plans_dir, entry.get("file", f"{key}.json"))
            return (load_plan(path).meta or {}).get("envelope")
    return None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--mesh", default=None,
                    help="RxC (data x model) mesh, e.g. 2x2: R*C ranks spawned on --device, "
                         "each holding its block of every weight")
    ap.add_argument("--profile", default="decode_tp", choices=list(PROFILES),
                    help="placement profile when --mesh is set")
    ap.add_argument("--engine", default="simple", choices=["simple", "continuous", "routed"],
                    help="simple whole-batch decode, the fixed-slot ContinuousBatcher on "
                         "one CUDA graph captured under the policy, or the "
                         "workload-routed bucketed serving tier")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help=f"uniform numerics policy for every GEMM site (default "
                         f"{MXU_BF16.name})")
    ap.add_argument("--precision-plan", default=None,
                    help="serve under a PrecisionPlan JSON (per-site numerics)")
    ap.add_argument("--workload", default="chat",
                    help="workload class (chat/solve/repro) or explicit plan name for "
                         "--engine routed")
    ap.add_argument("--plans", default="examples/plans",
                    help="plan zoo directory for --engine routed")
    ap.add_argument("--buckets", default=None,
                    help="slots x len bucket table for --engine routed, e.g. 2x32,4x64 "
                         "(default: one bucket sized to fit)")
    ap.add_argument("--monitor", action="store_true",
                    help="serve under live calibration-envelope monitors (envelope from "
                         "--precision-plan or the zoo plan); engines run eager steps")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the unified metrics registry (+ monitor snapshot) as "
                         "JSON when serving finishes")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose /metrics (Prometheus text) and /metrics.json on this "
                         "local port while serving")
    ap.add_argument("--metrics-hold", type=float, default=0.0,
                    help="keep the --metrics-port server up this many seconds after "
                         "serving completes")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the span timeline as Chrome-trace JSON")
    return ap


def main(argv=None) -> torch.Tensor:
    """The CLI (module docstring). Returns the generated tokens (B, gen) on
    the host; with ``--mesh``, rank 0's (every rank's are the same)."""
    args = _parser().parse_args(argv)
    if args.engine == "routed" and (args.precision_plan or args.policy):
        raise SystemExit("--engine routed picks plans from the zoo MANIFEST; use "
                         "--workload, not --precision-plan or --policy")
    policy_from_args(args)             # a bad --policy/--precision-plan fails before any spawn
    if args.mesh:
        if args.engine != "simple":
            raise SystemExit("--mesh is supported with --engine simple only")
        from repro_torch.launch.mesh import spawn
        r, c = parse_mesh(args.mesh)
        return spawn(_mesh_rank, r * c, device=args.device, args=(args,),
                     timeout=MESH_TIMEOUT_S, collective_timeout=MESH_COLLECTIVE_TIMEOUT_S)[0]
    return _run(args, resolve_device(args.device))


def _mesh_rank(dev, args) -> torch.Tensor:
    return _run(args, dev, make_mesh(parse_mesh(args.mesh)))


def _run(args, dev: torch.device, mesh=None) -> torch.Tensor:
    """Serve as the CLI asks on ``dev``; on ``mesh`` (every rank of its
    world runs this) under ``args.profile``'s placement, rank 0 printing."""
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    policy = policy_from_args(args)
    n_sched = preload_schedules(backend=dev.type)
    if n_sched:
        say(f"[serve] schedule zoo: {n_sched} GEMM schedules preloaded "
            f"(warm plan cache, zero autotune misses)")
    cfg = get_config(args.arch)
    base_arch = cfg.name
    if args.reduced:
        cfg = cfg.reduced()
    if args.engine != "simple" and cfg.family not in ("dense", "moe", "vlm"):
        raise SystemExit(f"--engine {args.engine} supports KV-cache families "
                         f"(dense/moe/vlm); {args.arch} is family={cfg.family!r} — use "
                         f"the default --engine simple")
    dist = LOCAL
    if mesh is None:
        params = init(cfg, seed=0, device=dev)
    else:
        dist = distribution_for(mesh, args.profile, numerics_policy=policy)
        params = init(cfg, seed=0, device=dev, dist=dist, profile=args.profile)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen)
    srv = None
    if args.metrics_port is not None and rank0:
        from repro_torch.obs import start_metrics_server
        srv = start_metrics_server(args.metrics_port)
        say(f"[serve] metrics at http://127.0.0.1:{srv.server_port}/metrics "
            f"(+ /metrics.json)")

    monitored = bool(args.monitor or args.metrics_dump)
    mon_ctx = contextlib.nullcontext(None)
    if monitored:
        from repro_torch.obs import monitoring
        envelope = None
        if args.precision_plan:
            from repro_torch.numerics import load_plan
            envelope = (load_plan(args.precision_plan).meta or {}).get("envelope")
        elif args.engine == "routed":
            envelope = _zoo_envelope(args.plans, base_arch)
        mon_ctx = monitoring(envelope=envelope)
        if args.engine != "simple":
            say(f"[serve] --monitor: the {args.engine} engine is captured with the "
                f"monitor's reductions inside (a CUDA graph on the card, eager steps "
                f"on the CPU)")

    STATS.reset()
    t0 = time.perf_counter()
    stack = contextlib.ExitStack()
    mon = stack.enter_context(mon_ctx)
    if args.engine == "routed":
        from repro_torch.serving import (BucketedEnginePool, PlanRouter, RoutedFrontend,
                                         ServeRequest)
        router = PlanRouter.from_manifest(args.plans, arch=base_arch)
        buckets = args.buckets or f"{args.batch}x{args.prompt_len + args.gen + 2}"
        pool = BucketedEnginePool(cfg, params, buckets)
        front = RoutedFrontend(pool, router)
        comps = [front.submit(ServeRequest(uid=i, prompt=row.tolist(), max_new=args.gen,
                                           workload=args.workload))
                 for i, row in enumerate(prompts)]
        front.run()
        toks = torch.tensor([c.result() for c in comps])
        st = front.stats()
        for wl, cs in st["classes"].items():
            plans = ", ".join(sorted(cs["plans"]))
            print(f"[serve:routed] {wl}: {cs['completed']}/{cs['submitted']} ok via "
                  f"{plans}  mean_steps={cs['mean_steps']:.1f} "
                  f"tok/s={cs['tokens_per_s']:.1f}")
        print(f"[serve:routed] pool: {st['pool']['compiles']} compiles, "
              f"buckets={st['pool']['bucket_hits']}")
        policy_name = "routed"
    elif args.engine == "continuous":
        from repro_torch.launch.batching import ContinuousBatcher, Request
        eng = ContinuousBatcher(cfg, params, n_slots=args.batch,
                                max_len=args.prompt_len + 2 * args.gen + 2,
                                warmup=policy)
        reqs = [Request(uid=i, prompt=row.tolist(), max_new=args.gen)
                for i, row in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        toks = torch.tensor([r.out for r in reqs])
        policy_name = policy.name
    else:
        with use_policy(policy):
            toks = serve(cfg, params, prompts, args.gen, device=dev, dist=dist)
        policy_name = policy.name
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stack.close()                      # uninstall the monitor, fold its queue
    dt = time.perf_counter() - t0
    toks = toks.cpu()
    say(f"[serve] {args.arch}: engine={args.engine} policy={policy_name} "
        f"device={dev} batch={args.batch} prompt={args.prompt_len} "
        f"gen={args.gen} in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    if mesh is not None:
        import torch.distributed as tdist
        held = [None] * mesh.size
        tdist.all_gather_object(held, placed_bytes(params))
        steps = args.prompt_len + args.gen     # prefill runs a decode step a prompt token
        say(f"[serve] mesh {mesh.describe()} ({', '.join(f'{a} {b}' for a, b in mesh.backends().items())}) "
            f"profile={args.profile}: placed {', '.join(f'{b / 1e6:.3f}' for b in held)} MB "
            f"by rank (replicated {placed_bytes(init_abstract(cfg)) / 1e6:.3f} MB); gathered "
            f"{STATS.bytes / steps / 1e6:.3f} MB a decode step ({steps} steps, "
            f"{STATS.received / steps / 1e6:.3f} MB received, {STATS.seconds:.2f} s "
            f"in gathers on rank 0)")
    say("sample:", toks[0].tolist())
    if mon is not None:
        say(f"[serve] monitor: worst={mon.worst_status()} over "
            f"{len(mon.statuses())} sites, overflow_events={mon.overflow_events()}")
    if args.metrics_dump and rank0:
        from repro_torch.obs import default_registry
        dump = {"kind": "repro.obs.ServingMetricsDump", "version": 1,
                "arch": args.arch, "engine": args.engine,
                "metrics": default_registry().snapshot(),
                "monitor": mon.snapshot() if mon is not None else None}
        with open(args.metrics_dump, "w") as f:
            json.dump(dump, f, indent=1, sort_keys=True, default=str)
        say(f"[serve] metrics dump -> {args.metrics_dump}")
    if args.trace_out and rank0:
        from repro_torch.obs import save_chrome_trace
        n_ev = save_chrome_trace(args.trace_out)
        say(f"[serve] chrome trace ({n_ev} events) -> {args.trace_out}")
    if srv is not None:
        if args.metrics_hold > 0:
            time.sleep(args.metrics_hold)
        srv.shutdown()
    return toks


if __name__ == "__main__":
    main()
