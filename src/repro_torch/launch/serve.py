"""Batched serving entry point (counterpart of ``repro.launch.serve``):
prefill + greedy incremental decode with an f32 KV cache.

On the card, under the FDP kernel policy:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --policy fdp91_kernel
On the CPU at test size (any dense or MoE architecture, e.g. dbrx-132b):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
        --reduced --device cpu

Under a precision plan (per-site numerics loaded from JSON):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --precision-plan examples/plans/qwen3_0p6b.json

``--policy`` picks one of the named uniform policies instead; passing both
is an error, so that it is never unclear which policy served.

``--engine continuous`` routes the same requests through the fixed-slot
``launch.batching.ContinuousBatcher``: one request a prompt row, a cache of
``prompt_len + 2 * gen + 2`` positions, the decode step captured in one CUDA
graph under the policy before the first request arrives (on the CPU: eager
steps). ``--engine routed`` (the workload-routed serving tier) comes with
the serving tier's second half (ROADMAP queue 1, *Serving tier*).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import (FDP91, MXU_BF16, MXU_FP32, GemmConfig,
                                       NumericsPolicy, policy_from_plan, use_policy)
from repro_torch.core.formats import FP32
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init, init_cache, prefill

# Every site through the hand-written FDP GEMM kernel at the paper's
# <30,30,-30> 91-bit accumulator (FDP91's numerics in ``pallas`` mode).
FDP91_KERNEL = NumericsPolicy(
    GemmConfig(FP32, AccumulatorSpec.paper_91bit(), "pallas"), name="fdp91_kernel")
POLICIES = {p.name: p for p in (MXU_BF16, MXU_FP32, FDP91, FDP91_KERNEL)}


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
def serve(cfg, params, prompts, gen_len: int, device=None) -> torch.Tensor:
    """prompts: (B, S) int. Greedy decode gen_len tokens. Returns (B, gen)
    int64 on ``device`` (CUDA unless the caller asks for another)."""
    dev = resolve_device(device)
    if not _on(params.embed, dev):
        raise ValueError(f"params are on {params.embed.device}, serving on {dev}")
    prompts = torch.as_tensor(prompts, device=dev)
    B, S = prompts.shape
    cache = init_cache(cfg, B, max_len=S + gen_len, dtype=torch.float32, device=dev)
    last_logits, cache = prefill(params, cfg, {"tokens": prompts}, cache)
    out = []
    tok = torch.argmax(last_logits, dim=-1)[:, None]
    for _ in range(gen_len):
        out.append(tok)
        logits, cache = decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--engine", default="simple", choices=["simple", "continuous"],
                    help="simple whole-batch decode, or the fixed-slot "
                         "ContinuousBatcher on one CUDA graph captured under the "
                         "policy (routed: the serving tier's second half)")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help=f"uniform numerics policy for every GEMM site (default "
                         f"{MXU_BF16.name})")
    ap.add_argument("--precision-plan", default=None,
                    help="serve under a PrecisionPlan JSON (per-site numerics)")
    args = ap.parse_args(argv)
    policy = policy_from_args(args)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen)
    t0 = time.perf_counter()
    if args.engine == "continuous":
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
    else:
        with use_policy(policy):
            toks = serve(cfg, params, prompts, args.gen, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.arch}: engine={args.engine} policy={policy.name} "
          f"device={dev} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", toks[0].tolist())


if __name__ == "__main__":
    main()
