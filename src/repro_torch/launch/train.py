"""End-to-end training driver (counterpart of ``repro.launch.train``, one
device).

On the card, dbrx-132b cut to the reduced config under the FDP kernel
policy with 8-bit block-scaled Adam moments:
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \\
        --reduced --policy fdp91_kernel --opt-precision 8x64
On the CPU at test size (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

Under a precision plan (every GEMM site, and the Adam moments where the
plan assigns ``opt.m@state``/``opt.v@state``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --precision-plan examples/plans/qwen3_0p6b.json

``--policy`` names a uniform policy instead; passing both is an error.
``--opt-precision`` wins over the plan's moment sites. ``--mesh``/
``--profile`` come with multi-device support (ROADMAP queue 1 item 12).
Without ``--ckpt`` checkpoints go to a temporary directory that is removed
at the end.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import MXU_BF16
from repro_torch.core.qformat import parse_quant
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.serve import POLICIES, policy_from_args
from repro_torch.train.loop import Trainer, make_train_step
from repro_torch.train.optimizer import adamw, cosine_schedule, state_quant_from_policy


def parse_opt_precision(text):
    """``--opt-precision``: 'FMT' for both moments or 'M_FMT,V_FMT' ->
    adamw's ``state_quant`` (None when both stay fp32)."""
    if not text:
        return None
    parts = [p.strip() for p in text.split(",")]
    if len(parts) not in (1, 2):
        raise SystemExit("--opt-precision takes 'FMT' or 'M_FMT,V_FMT'")
    cfgs = [parse_quant(p) for p in parts]
    if len(cfgs) == 1:
        cfgs = cfgs * 2
    return {m: c for m, c in zip(("mu", "nu"), cfgs) if c.mode == "block"} or None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--fdp-grad", action="store_true",
                    help="fixed-point (order-invariant) grad accumulation")
    ap.add_argument("--precision-plan", default=None,
                    help="train under a PrecisionPlan JSON (its GEMM sites, and "
                         "its optimizer-state sites unless --opt-precision is given)")
    ap.add_argument("--opt-precision", default=None,
                    help="store Adam moments block-scaled: 'fp32', "
                         "'BITSxBLOCK' ('8x64'), or 'M,V' per moment ('8x64,8x32'); "
                         "overrides the plan's @state sites")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="uniform numerics policy for every forward and "
                         f"backward GEMM site (default {MXU_BF16.name})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    fdp_spec = AccumulatorSpec(ovf=10, msb=10, lsb=-20) if args.fdp_grad else None
    policy = policy_from_args(args)
    # optimizer-state formats: --opt-precision wins, else the plan's
    # opt.m@state / opt.v@state assignments
    squant = (parse_opt_precision(args.opt_precision) if args.opt_precision
              else state_quant_from_policy(policy))
    opt = adamw(lr=cosine_schedule(args.lr, warmup=10, total=args.steps),
                state_quant=squant)
    if squant:
        print("[train] quantized optimizer state: "
              + ", ".join(f"{m}={c.tag()}" for m, c in sorted(squant.items())))
    step_fn = make_train_step(cfg, opt, remat="none", microbatches=args.microbatches,
                              fdp_grad_spec=fdp_spec, numerics_policy=policy)
    data_src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0, device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, opt, lambda step: data_src.batch(step).as_dict(), step_fn,
                          args.ckpt or tmp, save_every=args.save_every, device=dev)
        t0 = time.perf_counter()
        trainer.run(args.steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    losses = [m["loss"] for m in trainer.metrics_log]
    if args.log:
        with open(args.log, "w") as f:
            json.dump(trainer.metrics_log, f)
    if not losses:
        print(f"[train] {args.arch}: checkpoint at {args.ckpt} already covers "
              f"{args.steps} steps; nothing to do")
        return
    print(f"[train] {args.arch}{' (reduced)' if args.reduced else ''}: {args.steps} "
          f"steps in {dt:.1f}s; policy={policy.name} device={dev} loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; restarts {trainer.restarts}")
    if not losses[-1] < losses[0]:
        raise SystemExit("training did not reduce the loss")


if __name__ == "__main__":
    main()
