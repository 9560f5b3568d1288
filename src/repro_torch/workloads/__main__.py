"""Run the workload zoo against a policy (counterpart of
``python -m repro.workloads``, with ``--device``):

    PYTHONPATH=src python -m repro_torch.workloads --plan examples/plans/paper_mlp.json
    PYTHONPATH=src python -m repro_torch.workloads --arch qwen3-0.6b --reduced \\
        --validators grad,logits,repro,solve --device cpu

Loads the plan (arch/reduced are inferred from its meta unless given), builds
the requested validators on a seeded model context on ``--device`` (CUDA by
default; a missing card is an error, not a fallback), runs each against the
deployed policy, and prints the reports. With ``--tolerance T`` the
recomputed scores are also diffed against the scores the plan recorded at
search time (``meta.validation``): drift beyond T bits exits nonzero.
``--require-pass`` additionally fails on any below-threshold workload.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.workloads")
    ap.add_argument("--plan", default=None,
                    help="PrecisionPlan JSON to deploy (default: the bare "
                         "mxu_fp32 policy)")
    ap.add_argument("--arch", default=None,
                    help="architecture (default: the plan's recorded arch)")
    ap.add_argument("--reduced", action="store_true", default=None)
    ap.add_argument("--validators", default="grad,logits,repro",
                    help="comma list of workload names (see "
                         "repro_torch.workloads.available_workloads)")
    ap.add_argument("--budget", type=float, default=None,
                    help="threshold seed in bits (default: the plan's "
                         "budget_bits, else 10)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tolerance", type=float, default=None,
                    help="max |recomputed - recorded| score drift in bits "
                         "before failing (default: report only)")
    ap.add_argument("--require-pass", action="store_true",
                    help="exit nonzero if any workload scores below its "
                         "threshold")
    ap.add_argument("--device", default="cuda",
                    help="device the validators run on (cpu: the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import MXU_FP32
    from repro_torch.numerics import load_plan
    from repro_torch.workloads import WorkloadContext, build_validators

    plan = recorded = None
    if args.plan:
        plan = load_plan(args.plan)
        recorded = plan.meta.get("validation", {})
        if args.arch is None:
            args.arch = plan.meta.get("arch_alias") or plan.meta.get("arch")
        if args.reduced is None:
            args.reduced = bool(plan.meta.get("reduced"))
        if args.budget is None and plan.budget_bits is not None:
            args.budget = float(plan.budget_bits)
    if args.arch is None:
        raise SystemExit("--arch is required when --plan carries no arch")
    policy = plan.to_policy() if plan else MXU_FP32

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    names = [n for n in args.validators.split(",") if n and n != "none"]
    ctx = WorkloadContext.for_model(cfg, budget_bits=args.budget or 10.0,
                                    seed=args.seed, device=args.device)
    validators = build_validators(names, ctx)

    failures = []
    print(f"[workloads] policy {policy.name!r} on {cfg.name} "
          f"(reduced={bool(args.reduced)}, device {ctx.device})")
    for v in validators:
        rep = v.run(policy)
        line = "  " + rep.describe()
        rec = (recorded or {}).get(v.name)
        if rec is not None and rec.get("score") is not None:
            drift = abs(rep.score - float(rec["score"]))
            line += f"  [recorded {rec['score']:.1f}, drift {drift:.2f}]"
            if args.tolerance is not None and drift > args.tolerance:
                failures.append(f"{v.name}: score drifted {drift:.2f} bits "
                                f"from the recorded {rec['score']:.2f} "
                                f"(tolerance {args.tolerance})")
        if args.require_pass and not rep.passed:
            failures.append(f"{v.name}: {rep.score:.2f} < threshold "
                            f"{rep.threshold:g}")
        print(line)

    if failures:
        for f in failures:
            print(f"[workloads] FAIL: {f}")
        sys.exit(1)
    print(f"[workloads] OK: {len(validators)} workload(s) ran")


if __name__ == "__main__":
    main()
