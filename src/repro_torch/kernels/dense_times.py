"""Times of the dense FDP GEMM kernel at the main path's calls, for holding
two checkouts of the port side by side on one card, and for weighing the
launcher's choice of layout.

    python -m repro_torch.kernels.dense_times [--reps N] [--sweep]

For each shape it prints one JSON line: the call ``(B, M, K, N)``; at the
paper's 91-bit <30,30,-30> and at <9,6,-20> on the same inputs, the mean
milliseconds a call of warm back-to-back calls (CUDA events: where a call's
host work outlasts its kernel, as at the small shapes, this is the host's
time) and the kernel's own mean device time a launch (``torch.profiler``);
the card, and the file of the ``fdp_gemm`` it timed. The shapes:
qwen3-0.6b's and dbrx-132b's attention at decode (2 and 6 rows a head
group, 4 prompts of 32 positions), qwen3-0.6b's LM head at decode with its
weight broadcast (folded into 4 rows) and with a weight per batch element
(1 row each), its mlp_in at decode and at prefill (4 prompts of 16), the
benchmark's hot shape, and dbrx-132b's router and attn_q at decode. The
inputs come from a seeded generator on the card.

Without ``--sweep`` it calls only ``fdp_gemm(a, b, spec=..., fmt=...)``
and the configs, which every version of the port has: copied into another
checkout's ``src/repro_torch/kernels/`` and run there with that checkout's
``src`` on ``PYTHONPATH``, it times that checkout's kernel on the same
inputs. ``--sweep`` also launches, at 91 bits, every layout of
``fdp_gemm.dense_layouts`` for each shape, holds each output
``torch.equal`` to the wrapper's, and prints one more JSON line a shape:
the median device time of ``dense_launch``'s pick and of the fastest
layout, both layouts, the pick's rank by time and the fastest one's rank
by ``dense_cost``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.formats import FP32
from repro_torch.kernels import fdp_gemm as K

BATCH, PROMPT, POSITIONS = 4, 16, 32


def shapes() -> list:
    """``(name, (B, M, K, N), weight broadcast over B)`` of each timed call."""
    out = []
    for model in ("qwen3-0.6b", "dbrx-132b"):
        cfg = get_config(model)
        g, bkh = cfg.n_heads // cfg.n_kv_heads, BATCH * cfg.n_kv_heads
        short = model.split("-")[0]
        out.append((f"{short} attn_qk decode", (bkh, g, cfg.head_dim, POSITIONS), False))
        out.append((f"{short} attn_av decode", (bkh, g, POSITIONS, cfg.head_dim), False))
    q, d = get_config("qwen3-0.6b"), get_config("dbrx-132b")
    out.append(("qwen lm_head decode", (BATCH, 1, q.d_model, q.padded_vocab), True))
    out.append(("qwen lm_head decode, a weight per batch element",
                (BATCH, 1, q.d_model, q.padded_vocab), False))
    out.append(("qwen mlp_in decode", (BATCH, 1, q.d_model, q.d_ff), True))
    out.append(("qwen mlp_in prefill", (BATCH, PROMPT, q.d_model, q.d_ff), True))
    out.append(("bench hot shape", (1, 256, 1024, 256), False))
    out.append(("dbrx router decode", (1, BATCH, d.d_model, d.n_experts), False))
    out.append(("dbrx attn_q decode", (BATCH, 1, d.d_model, d.n_heads * d.head_dim), True))
    return out


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _traced_us(fn, symbol: str = "fdp_gemm_kernel") -> list:
    """The device microseconds of each launch of the kernel whose device
    symbol holds ``symbol`` (the dense kernel's by default; it is no
    substring of the sorted-segment kernel's) that ``fn`` makes, in order,
    from one ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and symbol in e.name),
                 key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in evs]


def device_ms(fn, reps: int, symbol: str = "fdp_gemm_kernel") -> float:
    """Mean device milliseconds of the kernel's launches (``_traced_us``)
    in ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    us = _traced_us(lambda: [fn() for _ in range(reps)], symbol)
    if not 0 < len(us) <= reps:
        raise RuntimeError(f"traced {len(us)} launches of {symbol} in {reps} calls")
    return sum(us) / len(us) / 1e3


def sweep(a: torch.Tensor, b: torch.Tensor, spec, reps: int) -> dict:
    """Every layout of ``dense_layouts`` for the call the wrapper makes of
    (a, b), launched through the library, each output held ``torch.equal``
    to the wrapper's; the median device time of each over ``reps``
    launches."""
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    want = K.fdp_gemm(a, b, spec=spec, fmt=FP32)
    a, b, pick = K.dense_plan(a, b, spec.num_limbs, sms)
    Bn, M, Kd = a.shape
    N = b.shape[2]
    lib = K.load()["fdp_gemm"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    numerics = K._numerics_args(spec, FP32)
    out = torch.empty((Bn, M, N), device=a.device)
    lays = list(K.dense_layouts(spec.num_limbs, M, N, Kd))

    def launch(lay):
        err = lib.fdp_gemm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), Bn, M, N, Kd,
                                  *a.stride(), *b.stride(), *numerics, lay.lc, lay.tm,
                                  lay.tx, lay.ty, lay.ks, lay.bks, stream)
        if err != 0:
            raise RuntimeError(f"layout {lay} refused: cudaError {err}")

    for lay in lays:
        launch(lay)
        torch.cuda.synchronize()
        if not torch.equal(out.view(want.shape), want):
            raise RuntimeError(f"layout {lay} differs from the wrapper's output")
    us = _traced_us(lambda: [launch(lay) for lay in lays for _ in range(reps)])
    if len(us) != reps * len(lays):
        return {"layouts": len(lays), "traced": len(us), "expected": reps * len(lays)}
    med = [sorted(us[i * reps:(i + 1) * reps])[reps // 2] for i in range(len(lays))]
    costs = [K.dense_cost(lay, Bn, M, N, Kd, sms) for lay in lays]
    best, at = min(range(len(lays)), key=med.__getitem__), lays.index(pick)
    as_list = lambda lay: [lay.lc, lay.tm, lay.tn, lay.tx, lay.ty, lay.ks, lay.bks]  # noqa: E731
    return {"layouts": len(lays), "pick": as_list(pick), "pick_ms": med[at] / 1e3,
            "best": as_list(lays[best]), "best_ms": med[best] / 1e3,
            "pick_time_rank": sorted(med).index(med[at]) + 1,
            "best_cost_rank": sorted(costs).index(costs[best]) + 1}


def main(argv: list) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sweep", action="store_true",
                    help="also time every layout the launcher weighs, at 91 bits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1]
    specs = {"91-bit": AccumulatorSpec.paper_91bit(), "<9,6,-20>": AccumulatorSpec(9, 6, -20)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (B, M, Kd, N), bcast in shapes():
        a = torch.randn(B, M, Kd, generator=gen, device=dev)
        b = torch.randn(1 if bcast else B, Kd, N, generator=gen, device=dev) * Kd ** -0.5
        b = b.expand(B, Kd, N)
        reps = max(1, args.reps // 10) if N * Kd > 10 ** 8 else args.reps
        row = {"name": name, "shape": [B, M, Kd, N], "weight_broadcast": bcast}
        for label, spec in specs.items():
            call = lambda: K.fdp_gemm(a, b, spec=spec, fmt=FP32)  # noqa: E731
            row[f"ms {label}"] = cuda_ms(call, reps)
            row[f"device_ms {label}"] = device_ms(call, reps)
        row.update(card=card[0] if card else None, kernel_wrapper=K.__file__)
        print(json.dumps(row), flush=True)
        if args.sweep:
            print(json.dumps({"name": name, "sweep": sweep(a, b, specs["91-bit"], 5)}),
                  flush=True)
        del a, b
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
