#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card (nvidia-smi name and power limit); build the FDP kernels from
     ``src/repro_torch/kernels/csrc/`` (one nvcc per source, in parallel)
     and print the seconds;
  2. the dense FDP GEMM kernel against its plain PyTorch version on the
     card, torch.equal, over formats, round/overflow modes, ragged and
     broadcast shapes, a K long enough that carries normalize inside the
     kernel's K loop, the full-width decode shapes of qwen3-0.6b, and the
     2-D router shape of dbrx-132b through ``ops.fdp_gemm``; then the
     sorted-segment kernel against its plain version over formats, modes,
     zero-size groups (leading and trailing), one group holding every row,
     rows past the total, the three full-width expert shapes of a dbrx-132b
     decode step and the 256 rows of its prefill;
  3. qwen3-0.6b at full width served (4 prompts x 16 tokens, 16 generated)
     under the 91-bit FDP kernel policy, with the kernel's launch count
     set to 0 just before the first run and read just after it, and held
     against the FDP dispatches; then timing repeats in turns with the same
     serve under native fp32, the cost yardstick; then one serve of each
     policy under torch.profiler, for the device's busy and idle time and
     the kernels' summed time;
  4. a 2-layer cut of the same model: forward logits in ``pallas`` mode
     (kernel) torch.equal to ``simulate`` mode (plain);
  5. dbrx-132b (MoE, 16 experts top-4) at full width, depth cut to 2 layers,
     served the same way as phase 3: both kernels' launch counts set to 0
     just before the first run and read just after, each held against its
     sites' dispatches (dense: attention, router, lm_head; sorted-segment:
     moe_in, moe_gate, moe_out);
  6. a 1-layer cut of dbrx-132b at full width, batch 1, prompt 4: forward
     logits in ``pallas`` mode torch.equal to ``simulate`` mode;
  7. the bounds of phase 2's kernel times;
  8. the sorted-segment weight-gradient kernel (the MoE ``@bwd.dB``)
     against its plain version on the card, torch.equal, over formats,
     round/overflow modes, zero-size groups (leading, inner, trailing, all),
     one group holding every row, rows past the total, one group longer
     than SAFE_CHUNK rows, and the three full-width expert shapes of a
     dbrx-132b training step (4 x 64 tokens, 1024 routed rows) on 64
     columns of g, timed on the whole shape; then the dense and
     sorted-segment kernels at that step's backward shapes, on slices: the
     LM head's dA and dB, the router's dB, and moe_in's dX against the
     transposed expert weights;
  9. dbrx-132b at full width, depth cut to 1 layer, trained: three steps of
     ``make_train_step`` (AdamW, cosine schedule, clip 1.0, both moments
     8x64) under the FDP kernel policy, with every kernel's launch count set
     to 0 just before the first step and read just after it, each held
     against its sites' forward and backward dispatches; a second run from
     the same seed must give the same parameters; three steps under native
     fp32 as the yardstick; one traced step per policy;
 10. the same model at batch 1 x seq 4: loss and every gradient in
     ``pallas`` mode torch.equal to ``simulate`` mode;
 11. the fault-tolerant ``Trainer`` on reduced dbrx-132b with checkpoints
     in a temporary directory: an injected failure at step 2 is recovered,
     and the final parameters equal those of a run without it, which must
     not restart;
 12. the seed-order kernel (``ops.fdp_gemm(impl="loop")``, one thread per
     output walking k in order, carries normalized every ``plan.bk``
     products) torch.equal to its plain version and to the vector kernel over
     formats, rne and saturate, the 91-bit and the paper's <9,6,-20> spec,
     ragged and strided operands, K past bk and past SAFE_CHUNK, the
     benchmark's hot shape (256,1024,256) at the seed tile (32,32,128) and
     qwen3-0.6b's lm_head decode and mlp_in prefill shapes, where it is timed
     beside the vector kernel; its launch count is set to 0 before the first
     call and read after the last;
 13. the generator: ``generate_gemm`` for the native, simulate and pallas
     targets (a given tile and plan_gemm's) at the quickstart's shape and at
     mlp_in's, for both specs; pallas torch.equal simulate; each report's
     ``describe()`` and the correct bits against an f64 product;
 14. qwen3-0.6b at full width served under a PrecisionPlan written to JSON
     and loaded back (``policy_from_plan``): FDP91 in pallas mode by default,
     <9,6,-20> at mlp_in/mlp_gate/mlp_out, lm_head native fp32; the dense
     kernel's launches equal the dispatches at the pallas sites (a trace
     hook attributes them by site: lm_head none), no backward site, tokens
     repeat, median of three serves; then at 2 layers the plan's logits
     torch.equal its simulate twin's, and their top-1 agreement with fp32;
 15. the checked-in zoo plan ``examples/plans/qwen3_0p6b.json`` (all native),
     unchanged, serving qwen3-0.6b at full width once with no FDP launch,
     and its Adam moments through ``state_quant_from_policy`` (8x64);
 16. one JSON line of per-kernel numbers, then the ``ok`` line.

The bound of a kernel time is the larger of its bytes (inputs read once,
output written once) over 3.35 TB/s (H100 SXM HBM3, NVIDIA data sheet) and
the int32 operations the function needs (``fdp_gemm.int32_ops``: one decode
per distinct operand element, 20 operations per product, for the seed-order
kernel as for the vector kernel, since they compute one function; for the
sorted-segment forward kernel, the rows in a group and the weights of the
non-empty groups; for the weight-gradient kernel, the rows in a group of x
and of g, and one product per (row in a group, d, f)) over the card's int32
rate: 132 SMs x 64 INT32 lanes (Hopper white paper) x 1.98 GHz (max SM
clock) = 16.73e12 op/s. The count leaves out the read-out of each output
(one per dW element, E*d*f of them), which with a few dozen rows per group
is a real share of the weight-gradient kernel's work.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BATCH, PROMPT, GEN = 4, 16, 16
SERVE_RUNS = 3
MOE_LAYERS = 2          # dbrx-132b depth cut: 31.0 GB of f32 parameters
# Training dbrx-132b: depth cut to 1 layer (17.97 GB of f32 parameters, as
# much again of gradients, 9.1 GB of 8x64 Adam moments), 4 x 64 tokens
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 1, 4, 64, 3, 1e-4
# kernel name -> the substring of its device symbol in a profiler trace
TRACE_NAMES = {"fdp_gemm": "fdp_gemm_kernel", "fdp_ragged_gemm": "fdp_ragged_gemm_kernel",
               "fdp_ragged_dw": "fdp_ragged_dw_kernel"}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}


def trace_serve(torch, serve_once) -> dict:
    """Run one serve under torch.profiler and read its device timeline:
    busy seconds (union of all device events), idle share of the trace's
    span, and the summed seconds and count of each FDP kernel; None when
    the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = serve_once()
    events = list(prof.events())
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev_events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy_us, lo, hi = busy_us + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy_us += hi - lo
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events))
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    kernels = {}
    for label, symbol in TRACE_NAMES.items():
        # "fdp_gemm_kernel" is not a substring of "fdp_ragged_gemm_kernel"
        evs = [e for e in dev_events if symbol in e.name]
        kernels[label] = {"count": len(evs),
                          "s": sum(e.time_range.elapsed_us() for e in evs) / 1e6}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_s": wall, "span_s": span_us / 1e6, "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / span_us, "device_events": len(dev_events),
            "fdp_kernels": sum(k["count"] for k in kernels.values()),
            "fdp_kernel_s": sum(k["s"] for k in kernels.values()),
            "kernels": kernels, "top": [(name[:60], us / 1e6) for name, us in top]}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repository")
    sys.path.insert(0, src)
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        fail(f"imported {repro_torch.__file__}, not the checkout's package")
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as D
    from repro_torch.core.accumulator import SAFE_CHUNK, AccumulatorSpec
    from repro_torch.core.formats import BF16, FP32, POSIT16_1, PositFormat
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import FDP91_KERNEL, serve
    from repro_torch.core.qformat import parse_quant
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import forward, init
    from repro_torch.train import optimizer as TO
    from repro_torch.train.loop import InjectedFailure, Trainer, make_loss_fn, make_train_step
    from repro_torch.train.optimizer import adamw, cosine_schedule

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. the card and the build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = K.load()
    log(f"built and loaded the FDP kernels {sorted(libs)} in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 2. kernels vs plain versions on the card ----------------------------
    P91 = AccumulatorSpec.paper_91bit()
    RNE = AccumulatorSpec(30, 30, -30, round_mode="rne")
    SAT = AccumulatorSpec(2, 4, -20, overflow_mode="saturate")
    gen = torch.Generator(device=dev).manual_seed(0)

    def on_grid(fmt, *ts):
        if isinstance(fmt, PositFormat):
            return [fmt.from_float(t) for t in ts]
        return [fmt.quantize(t) for t in ts]

    def operands(B, M, Kd, N, fmt, a_scale=1.0, b_scale=1.0, bcast=False,
                 positive=False):
        a = torch.randn(B, M, Kd, generator=gen, device=dev) * a_scale
        b = torch.randn(1 if bcast else B, Kd, N, generator=gen, device=dev) * b_scale
        if positive:
            a, b = a.abs(), b.abs()
        a, b = on_grid(fmt, a, b)
        return a, (b.expand(B, Kd, N) if bcast else b)

    def n_saturated(got, spec):
        # the register's extremes, rounded to f32 as the read-out does
        hi = torch.tensor((2 ** (spec.width - 1) - 1) * 2.0 ** spec.lsb).float()
        lo = -(2 ** (spec.width - 1)) * 2.0 ** spec.lsb
        n_sat = int(((got == hi.item()) | (got == lo)).sum())
        if n_sat == 0:
            fail("the saturate case never saturated")
        return n_sat

    # the slice's decode shapes at full width: (B, M, K, N) per site
    cfg = get_config("qwen3-0.6b")
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    smax, G = PROMPT + GEN, cfg.n_heads // cfg.n_kv_heads
    bkh = BATCH * cfg.n_kv_heads
    SITES = {
        "attn_q": (BATCH, 1, d, hq), "attn_k": (BATCH, 1, d, hkv),
        "attn_v": (BATCH, 1, d, hkv), "attn_qk": (bkh, G, cfg.head_dim, smax),
        "attn_av": (bkh, G, smax, cfg.head_dim), "attn_o": (BATCH, 1, hq, d),
        "mlp_in": (BATCH, 1, d, f), "mlp_gate": (BATCH, 1, d, f),
        "mlp_out": (BATCH, 1, f, d), "lm_head": (BATCH, 1, d, V),
    }
    weight_sites = {"attn_q", "attn_k", "attn_v", "attn_o", "mlp_in", "mlp_gate",
                    "mlp_out", "lm_head"}
    cases = [
        ("fp32 91-bit ragged", (3, 5, 70, 9), FP32, P91, {}),
        ("bf16 91-bit ragged", (2, 17, 300, 33), BF16, P91, {}),
        ("posit16_1 91-bit", (2, 4, 64, 40), POSIT16_1, P91, {}),
        ("fp32 rne", (2, 4, 200, 40), FP32, RNE, {}),
        ("fp32 saturate <2,4,-20>", (2, 4, 200, 40), FP32, SAT, {"a_scale": 4.0}),
        ("fp32 stride-0 weight", (4, 7, 96, 33), FP32, P91, {"bcast": True}),
        # each of the kernel's 8 K-slices holds 4 x SAFE_CHUNK + 5 positive
        # products, so limbs grow toward 2^31 and must normalize in the loop
        ("fp32 K-slices past the carry cadence", (1, 2, 32 * SAFE_CHUNK + 37, 64),
         FP32, P91, {"positive": True}),
    ]
    for site, (B, M, Kd, N) in SITES.items():
        kw = ({"b_scale": Kd ** -0.5, "bcast": True} if site in weight_sites
              else {"b_scale": 1.0})
        cases.append((f"decode {site}", (B, M, Kd, N), FP32, P91, kw))
    max_err = 0.0
    for name, (B, M, Kd, N), fmt, spec, kw in cases:
        a, b = operands(B, M, Kd, N, fmt, **kw)
        want = K.fdp_gemm_plain(a, b, spec=spec, fmt=fmt)
        got = K.fdp_gemm(a, b, spec=spec, fmt=fmt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"kernel != plain for {name} {(B, M, Kd, N)}: max |diff| {err}")
        extra = f", {n_saturated(got, spec)} outputs saturated" if spec is SAT else ""
        max_err = max(max_err, err)
        log(f"kernel == plain (torch.equal): {name} {(B, M, Kd, N)} "
            f"{fmt.name} {spec.describe()}{extra}")

    # dbrx-132b at full width: the router is a 2-D call, (T, d) @ (d, E)
    mcfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=MOE_LAYERS)
    md, mf, mE, mk = mcfg.d_model, mcfg.d_ff, mcfg.n_experts, mcfg.top_k
    a, b = operands(1, BATCH, md, mE, FP32, b_scale=md ** -0.5)
    ra, rb = a[0], b[0]
    want = K.fdp_gemm_plain(ra[None], rb[None], spec=P91, fmt=FP32)[0]
    got = ops.fdp_gemm(ra, rb, spec=P91, fmt=FP32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"2-D kernel != plain at the router shape: max |diff| "
             f"{(got - want).abs().max().item()}")
    router = {"shape": [BATCH, md, mE],
              "ms": cuda_ms(torch, lambda: ops.fdp_gemm(ra, rb, spec=P91, fmt=FP32), reps=50),
              "plain_ms": cuda_ms(torch, lambda: K.fdp_gemm_plain(
                  ra[None], rb[None], spec=P91, fmt=FP32), reps=3),
              **bound(4 * (BATCH * md + md * mE + BATCH * mE),
                      K.int32_ops(BATCH * md, md * mE, BATCH * md * mE))}
    log(f"kernel == plain (torch.equal): router 2-D {(BATCH, md)} @ {(md, mE)} "
        f"through ops.fdp_gemm (N = {mE} < the kernel's 32-column tile)")

    def routed_sizes(tokens: int, seed: int) -> list:
        """Group sizes of top-k routing with each token's k experts drawn at
        random, as a router with random weights spreads them."""
        g = torch.Generator().manual_seed(seed)
        ids = torch.stack([torch.randperm(mE, generator=g)[:mk] for _ in range(tokens)])
        return torch.bincount(ids.reshape(-1), minlength=mE).tolist()

    def ragged_operands(T, dd, ff, gs, fmt, x_scale=1.0, f_cols=None):
        x = torch.randn(T, dd, generator=gen, device=dev) * x_scale
        w = torch.randn(len(gs), dd, ff, generator=gen, device=dev) * dd ** -0.5
        x, w = on_grid(fmt, x, w)
        if f_cols is not None:
            w = w[:, :, :f_cols]                          # a strided column slice
        return x, w, torch.tensor(gs, dtype=torch.int32, device=dev)

    def ragged_work(T, dd, ff, gs):
        """Bytes and int32 operations this data needs: the rows that fall in
        a group and the weights of the non-empty groups, read once; the
        sizes; every output row written once."""
        rows = min(T, sum(gs))
        used = sum(1 for e, n in enumerate(gs) if n > 0 and sum(gs[:e]) < T)
        nbytes = 4 * (rows * dd + used * dd * ff + len(gs) + T * ff)
        return nbytes, K.int32_ops(rows * dd, used * dd * ff, rows * dd * ff), used

    gs_decode = routed_sizes(BATCH, seed=3)
    gs_prefill = routed_sizes(BATCH * PROMPT, seed=4)
    MOE_SITES = {"moe_in": (BATCH * mk, md, mf), "moe_gate": (BATCH * mk, md, mf),
                 "moe_out": (BATCH * mk, mf, md)}
    ragged_cases = [
        ("fp32 91-bit, empty groups leading, inner and trailing, 10 rows past the "
         "total", (40, 70, 40, [0, 9, 0, 14, 7, 0]), FP32, P91, {}),
        ("bf16 91-bit, odd widths", (33, 300, 33, [10, 0, 23]), BF16, P91, {}),
        ("posit16_1 91-bit", (24, 64, 40, [0, 12, 12, 0]), POSIT16_1, P91, {}),
        ("fp32 rne", (40, 200, 40, [0, 20, 0, 20]), FP32, RNE, {}),
        ("fp32 saturate <2,4,-20>", (40, 200, 40, [15, 0, 25]), FP32, SAT,
         {"x_scale": 64.0}),
        ("fp32 every row in one group", (32, 128, 64, [0, 0, 32, 0]), FP32, P91, {}),
        ("fp32 rows past the total (28 of 48)", (48, 96, 40, [7, 0, 13, 0, 0]), FP32,
         P91, {}),
    ]
    for site, (T, dd, ff) in MOE_SITES.items():
        ragged_cases.append((f"decode {site} at full width, groups {gs_decode}",
                             (T, dd, ff, gs_decode), FP32, P91, {}))
    ragged_cases.append((f"prefill moe_in, {BATCH * PROMPT * mk} rows, the first 512 of "
                         f"{mf} columns (a strided view), groups {gs_prefill}",
                         (BATCH * PROMPT * mk, md, mf, gs_prefill), FP32, P91,
                         {"f_cols": 512}))
    ragged_err, ragged_sites = 0.0, {}
    for name, (T, dd, ff, gs), fmt, spec, kw in ragged_cases:
        x, w, sizes = ragged_operands(T, dd, ff, gs, fmt, **kw)
        want = K.fdp_ragged_gemm_plain(x, w, sizes, spec=spec, fmt=fmt)
        got = K.fdp_ragged_gemm(x, w, sizes, spec=spec, fmt=fmt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"sorted-segment kernel != plain for {name}: max |diff| {err}")
        if got[sum(gs):].any():
            fail(f"rows past the total are not zero for {name}")
        extra = f", {n_saturated(got, spec)} outputs saturated" if spec is SAT else ""
        ragged_err = max(ragged_err, err)
        log(f"sorted-segment kernel == plain (torch.equal): {name} "
            f"x {tuple(x.shape)} w {tuple(w.shape)} {fmt.name} {spec.describe()}{extra}")
        site = name.split()[1] if name.startswith("decode") else None
        if site in MOE_SITES:
            nbytes, nops, used = ragged_work(T, dd, ff, gs)
            ragged_sites[site] = {
                "shape": [T, dd, ff], "groups": gs, "non_empty_groups": used,
                "ms": cuda_ms(torch, lambda: K.fdp_ragged_gemm(x, w, sizes, spec=P91,
                                                               fmt=FP32), reps=20),
                "plain_ms": cuda_ms(torch, lambda: K.fdp_ragged_gemm_plain(
                    x, w, sizes, spec=P91, fmt=FP32), reps=1),
                "int32_ops_per_product": nops / (min(T, sum(gs)) * dd * ff),
                **bound(nbytes, nops)}
        del x, w, want, got
    torch.cuda.empty_cache()

    # -- 3. and 5. serve a model at full width -------------------------------
    def serve_phase(cfg, params, counters: dict, site_ms: dict):
        """Serve under the kernel policy with every counter set to 0 just
        before the first run and read just after; then timing repeats in
        turns with native fp32 and one traced serve per policy. counters:
        kernel name -> (wrapper, the sites whose dispatches it launches)."""
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(1))

        def timed_serve(policy):
            with D.use_policy(policy):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = serve(cfg, params, prompts, GEN, device=dev)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t

        D.reset_sites_seen()
        for wrapper, _ in counters.values():
            wrapper.launches = 0
        toks, dt = timed_serve(FDP91_KERNEL)
        launches = {name: wrapper.launches for name, (wrapper, _) in counters.items()}
        calls = D.site_calls()
        n_fdp = sum(calls.values())
        if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            fail(f"served tokens malformed: shape {tuple(toks.shape)}")
        expected = set().union(*(sites for _, sites in counters.values()))
        if set(calls) != expected:
            fail(f"dispatched sites {sorted(calls)} != {sorted(expected)}")
        for name, (_, sites) in counters.items():
            n = sum(calls[s] for s in sites)
            if launches[name] <= 0 or launches[name] != n:
                fail(f"{name} launches {launches[name]} != its sites' FDP dispatches {n}")
        # an estimate of the serve's kernel time: per-site CUDA-event means of
        # warm back-to-back launches, times the serve's calls (the trace below
        # measures it inside the serve)
        kernel_ms = sum(calls[s] * site_ms[s] for s in calls)
        fdp_s, fp32_s = [dt], []
        for i in range(SERVE_RUNS):
            toks32, dt32 = timed_serve(D.MXU_FP32)
            fp32_s.append(dt32)
            if i + 1 < SERVE_RUNS:
                again, dt_again = timed_serve(FDP91_KERNEL)
                if not torch.equal(again, toks):
                    fail("FDP-served tokens differ between runs")
                fdp_s.append(dt_again)
        med, med32 = sorted(fdp_s)[len(fdp_s) // 2], sorted(fp32_s)[len(fp32_s) // 2]
        traces = {pol.name: trace_serve(torch, lambda: timed_serve(pol))
                  for pol in (FDP91_KERNEL, D.MXU_FP32)}
        log(f"serve {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
            f"{cfg.vocab_size}) under {FDP91_KERNEL.name}: batch {BATCH} prompt "
            f"{PROMPT} gen {GEN}; kernel launches "
            + ", ".join(f"{n} {launches[n]}" for n in counters)
            + f" == FDP dispatches {n_fdp} (first run)")
        log(f"  seconds per serve, {SERVE_RUNS} runs: "
            f"{', '.join(f'{x:.3f}' for x in fdp_s)}; median {med:.3f} s = "
            f"{BATCH * GEN / med:.2f} tok/s")
        log(f"estimate (per-site CUDA-event means x calls, not a trace): kernel "
            f"{kernel_ms / n_fdp:.4f} ms per launch, {kernel_ms / 1e3:.3f} s per serve "
            f"= {100 * kernel_ms / 1e3 / med:.1f}% of the median serve")
        for site in sorted(calls, key=lambda s: -calls[s] * site_ms[s]):
            log(f"  {site:10s} calls {calls[site]:5d} {site_ms[site]:.4f} ms/launch")
        for name, t in traces.items():
            if t is None:
                log(f"traced serve under {name}: torch.profiler recorded no device "
                    f"events, so device busy time and idle share are not measured")
                continue
            log(f"traced serve under {name} (torch.profiler): wall {t['wall_s']:.3f} s, "
                f"trace span {t['span_s']:.3f} s, device busy {t['device_busy_s']:.3f} s, "
                f"idle share {100 * t['idle_share']:.1f}%, {t['device_events']} device "
                f"events, FDP kernels {t['fdp_kernels']} (FDP dispatches "
                f"{n_fdp if name == FDP91_KERNEL.name else 0}) summing "
                f"{t['fdp_kernel_s']:.3f} s: "
                + "; ".join(f"{k} {v['count']} in {v['s']:.3f} s"
                            for k, v in t["kernels"].items()))
            log("  top device time: " + "; ".join(f"{n} {x:.3f} s" for n, x in t["top"]))
        log(f"sample tokens: {toks[0].tolist()}")
        agree = float((toks32 == toks).float().mean())
        log(f"serve under {D.MXU_FP32.name} (native fp32 matmul, the yardstick), "
            f"{SERVE_RUNS} runs: {', '.join(f'{x:.3f}' for x in fp32_s)}; median "
            f"{med32:.3f} s = {BATCH * GEN / med32:.2f} tok/s; FDP/fp32 = "
            f"{med / med32:.2f}x; greedy tokens agree on {100 * agree:.1f}%")
        return {"launches": launches, "calls": calls, "serve_s": fdp_s,
                "fp32_serve_s": fp32_s, "tok_s": BATCH * GEN / med,
                "fp32_tok_s": BATCH * GEN / med32, "kernel_s_estimate": kernel_ms / 1e3,
                "trace": {name: t and {k: v for k, v in t.items() if k != "top"}
                          for name, t in traces.items()}}

    def dense_site_ms(sites: dict) -> dict:
        out = {}
        for site, (B, M, Kd, N) in sites.items():
            a, b = operands(B, M, Kd, N, FP32, b_scale=Kd ** -0.5,
                            bcast=site != "attn_qk" and site != "attn_av")
            out[site] = cuda_ms(torch, lambda: K.fdp_gemm(a, b, spec=P91, fmt=FP32),
                                reps=20 if site == "lm_head" else 50)
        return out

    params = init(cfg, seed=0, device=dev)
    spec_ms = dense_site_ms(SITES)
    qwen = serve_phase(cfg, params, {"fdp_gemm": (K.fdp_gemm, set(SITES))}, spec_ms)
    del params

    # -- 4. kernel path vs plain path at model level -------------------------
    def pallas_equals_simulate(cfg, batch_shape, seed):
        params = init(cfg, seed=0, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, batch_shape,
                                         generator=torch.Generator().manual_seed(seed)).to(dev)}
        simulate = D.NumericsPolicy(dataclasses.replace(FDP91_KERNEL.default,
                                                        mode="simulate"))
        with torch.no_grad():
            with D.use_policy(FDP91_KERNEL):
                t = time.perf_counter()
                lk = forward(params, cfg, batch)
                torch.cuda.synchronize()
                tk = time.perf_counter() - t
            with D.use_policy(simulate):
                t = time.perf_counter()
                ls = forward(params, cfg, batch)
                torch.cuda.synchronize()
                ts = time.perf_counter() - t
        if lk.shape != batch_shape + (cfg.padded_vocab,) \
                or not bool(torch.isfinite(lk[..., :cfg.vocab_size]).all()):
            fail(f"forward logits malformed: {tuple(lk.shape)}")
        if not torch.equal(lk, ls):
            fail(f"pallas != simulate logits for {cfg.name} at {cfg.n_layers} layers: "
                 f"max |diff| {(lk - ls).abs().max().item()}")
        log(f"{cfg.n_layers}-layer full-width {cfg.name} forward {batch_shape}: pallas "
            f"logits torch.equal simulate logits ({tk:.3f} s kernel path, {ts:.3f} s "
            f"plain path)")
        del params
        torch.cuda.empty_cache()
        return {"kernel_s": tk, "plain_s": ts}

    pallas_equals_simulate(dataclasses.replace(cfg, n_layers=2), (BATCH, PROMPT), seed=2)

    # -- 5. serve dbrx-132b (MoE) at full width, 2 layers --------------------
    mhkv = mcfg.n_kv_heads * mcfg.head_dim
    MOE_DENSE = {
        "attn_q": (BATCH, 1, md, mcfg.n_heads * mcfg.head_dim),
        "attn_k": (BATCH, 1, md, mhkv), "attn_v": (BATCH, 1, md, mhkv),
        "attn_qk": (BATCH * mcfg.n_kv_heads, mcfg.n_heads // mcfg.n_kv_heads,
                    mcfg.head_dim, smax),
        "attn_av": (BATCH * mcfg.n_kv_heads, mcfg.n_heads // mcfg.n_kv_heads, smax,
                    mcfg.head_dim),
        "attn_o": (BATCH, 1, mcfg.n_heads * mcfg.head_dim, md),
        "lm_head": (BATCH, 1, md, mcfg.padded_vocab),
    }
    moe_ms = dense_site_ms(MOE_DENSE)
    moe_ms["moe_router"] = router["ms"]
    moe_ms.update({s: r["ms"] for s, r in ragged_sites.items()})
    t = time.perf_counter()
    params = init(mcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"dbrx-132b at {MOE_LAYERS} layers: {n_params / 1e9:.3f} G f32 parameters = "
        f"{4 * n_params / 1e9:.2f} GB, initialized in {time.perf_counter() - t:.2f} s")
    dbrx = serve_phase(mcfg, params, {
        "fdp_gemm": (K.fdp_gemm, set(MOE_DENSE) | {"moe_router"}),
        "fdp_ragged_gemm": (K.fdp_ragged_gemm, set(MOE_SITES))}, moe_ms)
    del params
    torch.cuda.empty_cache()

    # -- 6. MoE kernel path vs plain path at model level ---------------------
    dbrx_eq = pallas_equals_simulate(dataclasses.replace(mcfg, n_layers=1), (1, 4), seed=5)

    # -- 7. per-kernel numbers -----------------------------------------------
    def at_shape(site):
        B, M, Kd, N = SITES[site]
        a, b = operands(B, M, Kd, N, FP32, b_scale=Kd ** -0.5, bcast=True)
        products = B * M * Kd * N
        ops_n = K.int32_ops(B * M * Kd, Kd * N, products)    # weight decoded once
        plain_ms = cuda_ms(torch, lambda: K.fdp_gemm_plain(a, b, spec=P91, fmt=FP32),
                           reps=2)
        return {"shape": [B, M, Kd, N], "ms": spec_ms[site], "plain_ms": plain_ms,
                "int32_ops_per_product": ops_n / products,
                **bound(4 * (B * M * Kd + Kd * N + B * M * N), ops_n)}

    lm, mi = at_shape("lm_head"), at_shape("mlp_in")
    for site, r in (("qwen lm_head", lm), ("qwen mlp_in", mi), ("dbrx router", router),
                    *((f"dbrx {s}", r) for s, r in ragged_sites.items())):
        log(f"bound at {site}: {r['bound_ms']:.4f} ms ({r['bound_by']}; int32 ops at "
            f"{INT32_OPS_PER_S:.4g} op/s, bytes at {HBM_BYTES_PER_S:.3g} B/s); kernel "
            f"{r['ms']:.4f} ms = {100 * r['bound_ms'] / r['ms']:.1f}% of bound; plain "
            f"{r['plain_ms']:.2f} ms")
    # -- 8. the weight-gradient kernel; kernels 1 and 3 at backward shapes ----
    tcfg = dataclasses.replace(mcfg, n_layers=TRAIN_LAYERS)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    T_rows = n_tok * mk                          # routed rows of one training step
    gs_train = routed_sizes(n_tok, seed=6)

    def dw_operands(T, dd, ff, fmt, x_scale=1.0, positive=False):
        x = torch.randn(T, dd, generator=gen, device=dev) * x_scale
        g = torch.randn(T, ff, generator=gen, device=dev) * ff ** -0.5
        if positive:
            x, g = x.abs(), g.abs()
        return on_grid(fmt, x, g)

    def dw_work(T, dd, ff, gs):
        """Bytes and int32 operations this data needs: the rows that fall in
        a group, of x and of g, and the sizes, read once; every dW element
        written once; one product per (row in a group, d, f)."""
        rows = min(T, sum(gs))
        nbytes = 4 * (rows * dd + rows * ff + len(gs) + len(gs) * dd * ff)
        return nbytes, K.int32_ops(rows * dd, rows * ff, rows * dd * ff)

    long_rows = 9 * SAFE_CHUNK + 517
    dw_cases = [
        ("fp32 91-bit, empty groups leading, inner and trailing, 10 rows past the "
         "total", (40, 70, 40, [0, 9, 0, 14, 7, 0]), FP32, P91, {}),
        ("bf16 91-bit, odd widths", (33, 300, 33, [10, 0, 23]), BF16, P91, {}),
        ("posit16_1 91-bit", (24, 64, 40, [0, 12, 12, 0]), POSIT16_1, P91, {}),
        ("fp32 rne", (40, 200, 40, [0, 20, 0, 20]), FP32, RNE, {}),
        ("fp32 saturate <2,4,-20>", (40, 200, 40, [15, 0, 25]), FP32, SAT,
         {"x_scale": 256.0}),
        ("fp32 every group empty", (16, 40, 40, [0, 0, 0]), FP32, P91, {}),
        ("fp32 every row in one group", (32, 128, 64, [0, 0, 32, 0]), FP32, P91, {}),
        ("fp32 rows past the total (28 of 48)", (48, 96, 40, [7, 0, 13, 0, 0]), FP32,
         P91, {}),
        (f"fp32 one group of {long_rows} rows (9 x SAFE_CHUNK + 517), positive, so "
         f"carries normalize inside the row loop", (long_rows + 40, 4, 32,
                                                     [0, long_rows, 0]), FP32, P91,
         {"positive": True}),
    ]
    dw_err = 0.0
    for name, (T, dd, ff, gs), fmt, spec, kw in dw_cases:
        x, g = dw_operands(T, dd, ff, fmt, **kw)
        sizes = torch.tensor(gs, dtype=torch.int32, device=dev)
        want = K.fdp_ragged_dw_plain(x, g, sizes, spec=spec, fmt=fmt)
        got = K.fdp_ragged_dw(x, g, sizes, spec=spec, fmt=fmt)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        if not torch.equal(got, want):
            fail(f"weight-gradient kernel != plain for {name}: max |diff| {err}")
        if any(got[e].any() for e, n in enumerate(gs) if n == 0):
            fail(f"a zero-size group's dW is not exactly zero for {name}")
        extra = f", {n_saturated(got, spec)} outputs saturated" if spec is SAT else ""
        dw_err = max(dw_err, err)
        log(f"weight-gradient kernel == plain (torch.equal): {name} x {tuple(x.shape)} "
            f"g {tuple(g.shape)} groups {gs} {fmt.name} {spec.describe()}{extra}")
    DW_SITES = {"moe_in": (T_rows, md, mf), "moe_gate": (T_rows, md, mf),
                "moe_out": (T_rows, mf, md)}
    dw_sites = {}
    for site, (T, dd, ff) in DW_SITES.items():
        x, g = dw_operands(T, dd, ff, FP32)
        sizes = torch.tensor(gs_train, dtype=torch.int32, device=dev)
        # the plain version on 64 columns of g (a strided view for moe_gate),
        # the kernel timed on the whole shape
        cols = slice(None, None, ff // 64) if site == "moe_gate" else slice(0, 64)
        want = K.fdp_ragged_dw_plain(x, g[:, cols], sizes, spec=P91, fmt=FP32)
        got = K.fdp_ragged_dw(x, g[:, cols], sizes, spec=P91, fmt=FP32)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"weight-gradient kernel != plain at {site}'s training shape: max |diff| "
                 f"{(got - want).abs().max().item()}")
        nbytes, nops = dw_work(T, dd, ff, gs_train)
        dw_sites[site] = {
            "shape": [T, dd, ff], "groups": gs_train,
            "ms": cuda_ms(torch, lambda: K.fdp_ragged_dw(x, g, sizes, spec=P91, fmt=FP32),
                          reps=2),
            "plain_ms": cuda_ms(torch, lambda: K.fdp_ragged_dw_plain(
                x, g[:, cols], sizes, spec=P91, fmt=FP32), reps=1),
            "plain_at": f"64 columns of g ({'strided' if site == 'moe_gate' else 'the first'})",
            "outputs": len(gs_train) * dd * ff,
            "int32_ops_per_product": nops / (T * dd * ff), **bound(nbytes, nops)}
        log(f"weight-gradient kernel == plain (torch.equal): {site} at its training shape, "
            f"x {tuple(x.shape)} g {tuple(g.shape)} on {dw_sites[site]['plain_at']}, "
            f"groups {gs_train}")
        r = dw_sites[site]
        log(f"bound at dbrx {site}@bwd.dB: {r['bound_ms']:.4f} ms ({r['bound_by']}); kernel "
            f"{r['ms']:.4f} ms on the whole shape = {100 * r['bound_ms'] / r['ms']:.1f}% of "
            f"bound; plain {r['plain_ms']:.2f} ms on {r['plain_at']}")
        del x, g, want, got
        torch.cuda.empty_cache()

    # kernels 1 and 3 at the step's backward shapes, the plain version on slices
    mV = tcfg.padded_vocab
    head = torch.randn(md, mV, generator=gen, device=dev) * md ** -0.5
    g_logits = torch.randn(TRAIN_BATCH, TRAIN_SEQ, mV, generator=gen, device=dev) * 1e-3
    h = torch.randn(TRAIN_BATCH, TRAIN_SEQ, md, generator=gen, device=dev)
    w_in = torch.randn(mE, md, mf, generator=gen, device=dev) * md ** -0.5
    g_moe = torch.randn(T_rows, mf, generator=gen, device=dev) * 1e-2
    x_tok = torch.randn(n_tok, md, generator=gen, device=dev)
    g_router = torch.randn(n_tok, mE, generator=gen, device=dev) * 1e-2
    sizes = torch.tensor(gs_train, dtype=torch.int32, device=dev)
    bwd_checks = {
        # G (B,S,V) @ head^T (V,d) with head^T a transposed view broadcast over B
        "lm_head@bwd.dA, 32 of 6144 columns": lambda f: f(
            g_logits, head.T[:, :32].expand(TRAIN_BATCH, mV, 32)),
        # the flattened h^T (d,T) @ G (T,V), a transposed view, 64 of V columns
        "lm_head@bwd.dB, 64 columns": lambda f: f(
            h.reshape(-1, md).T[None], g_logits.reshape(-1, mV)[None, :, :64]),
        "moe_router@bwd.dB (2-D, whole)": lambda f: f(x_tok.T[None], g_router[None]),
    }
    for name, call in bwd_checks.items():
        want = call(lambda a, b: K.fdp_gemm_plain(a, b, spec=P91, fmt=FP32))
        got = call(lambda a, b: K.fdp_gemm(a, b, spec=P91, fmt=FP32))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"dense kernel != plain at {name}: max |diff| {(got - want).abs().max().item()}")
        max_err = max(max_err, (got - want).abs().max().item())
        log(f"dense kernel == plain (torch.equal): {name}")
    w_t = w_in.transpose(-1, -2)[:, :, :64]              # (E, f, 64 of d), strided
    want = K.fdp_ragged_gemm_plain(g_moe, w_t, sizes, spec=P91, fmt=FP32)
    got = K.fdp_ragged_gemm(g_moe, w_t, sizes, spec=P91, fmt=FP32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"sorted-segment kernel != plain at moe_in@bwd.dA: max |diff| "
             f"{(got - want).abs().max().item()}")
    log(f"sorted-segment kernel == plain (torch.equal): moe_in@bwd.dA, g {tuple(g_moe.shape)} "
        f"against w^T {tuple(w_in.transpose(-1, -2).shape)} (a transposed view), 64 of "
        f"{md} columns, groups {gs_train}")
    del head, g_logits, h, w_in, g_moe, x_tok, g_router, w_t, want, got
    torch.cuda.empty_cache()

    # -- 9. train dbrx-132b at full width, 1 layer --------------------------
    qcfg = parse_quant("8x64")
    data = SyntheticLM(tcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=dev)
    batches = [data.batch(i).as_dict() for i in range(TRAIN_STEPS)]
    counters = {"fdp_gemm": K.fdp_gemm, "fdp_ragged_gemm": K.fdp_ragged_gemm,
                "fdp_ragged_dw": K.fdp_ragged_dw}

    def kernel_of(site: str) -> str:
        name, _, phase = site.partition("@")
        if name in MOE_SITES:
            return "fdp_ragged_dw" if phase == "bwd.dB" else "fdp_ragged_gemm"
        return "fdp_gemm"

    def make_opt():
        return adamw(lr=cosine_schedule(TRAIN_LR, warmup=1, total=TRAIN_STEPS),
                     clip_norm=1.0, state_quant={"mu": qcfg, "nu": qcfg})

    def checksums(params) -> dict:
        """Per parameter, the int64 sums of its f32 bit patterns over slices
        of 2^24 elements (no second copy of the parameters is kept)."""
        return {n: torch.stack([torch.sum(c.view(torch.int32), dtype=torch.int64)
                                for c in p.detach().reshape(-1).split(1 << 24)]).tolist()
                for n, p in params.named_parameters()}

    def train_run(policy, count_first=False):
        """TRAIN_STEPS steps from seed 0: (params, opt, state, seconds per step,
        losses, first-step launches and dispatches, peak bytes)."""
        params = init(tcfg, seed=0, device=dev)
        opt = make_opt()
        state = opt.init(params)
        step = make_train_step(tcfg, opt, remat="none", numerics_policy=policy)
        secs, losses, first, peak = [], [], None, 0
        for i, batch in enumerate(batches):
            if count_first and i == 0:
                D.reset_sites_seen()
                for wrapper in counters.values():
                    wrapper.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            (params, state), metrics = step((params, state), batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            if count_first and i == 0:
                first = {"launches": {n: w.launches for n, w in counters.items()},
                         "calls": D.site_calls()}
            peak = max(peak, torch.cuda.max_memory_allocated())
            losses.append(float(metrics["loss"]))
        return params, opt, state, secs, losses, first, peak

    t = time.perf_counter()
    params, opt, state, fdp_secs, fdp_losses, first, fdp_peak = train_run(
        FDP91_KERNEL, count_first=True)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"dbrx-132b at {TRAIN_LAYERS} layer, full width: {n_params / 1e9:.3f} G f32 "
        f"parameters = {4 * n_params / 1e9:.2f} GB; AdamW moments {qcfg.tag()} "
        f"({TO.optimizer_state_bytes(state) / 1e9:.2f} GB); batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} = {n_tok} tokens, {T_rows} routed rows; {TRAIN_STEPS} steps under "
        f"{FDP91_KERNEL.name} in {time.perf_counter() - t:.1f} s")
    calls = first["calls"]
    for name, n in first["launches"].items():
        want_n = sum(c for s, c in calls.items() if kernel_of(s) == name)
        sites = sorted(s for s in calls if kernel_of(s) == name)
        if n <= 0 or n != want_n:
            fail(f"{name} launched {n} times in the first training step, its sites "
                 f"dispatched {want_n}: {sites}")
        log(f"  first step: {name} launches {n} == dispatches of its sites "
            f"({', '.join(f'{s} {calls[s]}' for s in sites)})")
    if not all(map(math.isfinite, fdp_losses)):
        fail(f"training loss not finite: {fdp_losses}")
    sums = checksums(params)
    del params, opt, state
    torch.cuda.empty_cache()
    params, opt, state, fdp_secs2, fdp_losses2, _, _ = train_run(FDP91_KERNEL)
    if checksums(params) != sums or fdp_losses2 != fdp_losses:
        fail("a second training run from the same seed gave other parameters")
    log(f"  losses {fdp_losses}; a second run from the same seed gives the same "
        f"parameters (per-slice checksums of every parameter) and losses")
    del params, opt, state
    torch.cuda.empty_cache()
    params, opt, state, fp32_secs, fp32_losses, _, fp32_peak = train_run(D.MXU_FP32)
    fdp_med = sorted(fdp_secs2)[len(fdp_secs2) // 2]
    fp32_med = sorted(fp32_secs)[len(fp32_secs) // 2]

    def traced_step(policy):
        step = make_train_step(tcfg, opt, remat="none", numerics_policy=policy)

        def once():
            nonlocal params, state
            torch.cuda.synchronize()
            t = time.perf_counter()
            (params, state), _ = step((params, state), batches[0])
            torch.cuda.synchronize()
            return None, time.perf_counter() - t
        return trace_serve(torch, once)

    train_traces = {pol.name: traced_step(pol) for pol in (FDP91_KERNEL, D.MXU_FP32)}
    del params, opt, state
    torch.cuda.empty_cache()
    train = {"step_s": fdp_secs + fdp_secs2, "fp32_step_s": fp32_secs,
             "median_step_s": fdp_med, "fp32_median_step_s": fp32_med,
             "tok_s": n_tok / fdp_med, "fp32_tok_s": n_tok / fp32_med,
             "peak_bytes": fdp_peak, "fp32_peak_bytes": fp32_peak,
             "losses": fdp_losses, "fp32_losses": fp32_losses,
             "launches": first["launches"], "calls": calls,
             "trace": {n: t and {k: v for k, v in t.items() if k != "top"}
                       for n, t in train_traces.items()}}
    for pol, secs, med, peak in ((FDP91_KERNEL.name, fdp_secs + fdp_secs2, fdp_med, fdp_peak),
                                 (D.MXU_FP32.name, fp32_secs, fp32_med, fp32_peak)):
        log(f"train step under {pol}: seconds {', '.join(f'{s:.3f}' for s in secs)}; "
            f"median (last {TRAIN_STEPS}) {med:.3f} s = {n_tok / med:.1f} trained tok/s; "
            f"peak memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    log(f"FDP/fp32 step time {fdp_med / fp32_med:.2f}x; fp32 losses {fp32_losses}")
    for name, t in train_traces.items():
        if t is None:
            log(f"traced step under {name}: torch.profiler recorded no device events, so "
                f"device busy time and idle share are not measured")
            continue
        log(f"traced step under {name} (torch.profiler): wall {t['wall_s']:.3f} s, trace "
            f"span {t['span_s']:.3f} s, device busy {t['device_busy_s']:.3f} s, idle share "
            f"{100 * t['idle_share']:.1f}%: "
            + "; ".join(f"{k} {v['count']} in {v['s']:.3f} s" for k, v in t["kernels"].items()))
        log("  top device time: " + "; ".join(f"{n} {x:.3f} s" for n, x in t["top"]))

    # -- 10. one loss and backward: pallas gradients == simulate gradients ----
    params = init(tcfg, seed=0, device=dev)
    small = SyntheticLM(tcfg.vocab_size, 4, 1, seed=7, device=dev).batch(0).as_dict()
    loss_fn = make_loss_fn(tcfg, remat="none")
    names, leaves = zip(*params.named_parameters())
    simulate = D.NumericsPolicy(dataclasses.replace(FDP91_KERNEL.default, mode="simulate"))

    def loss_and_grads(policy):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with D.use_policy(policy):
            loss, _ = loss_fn(params, small)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), grads, time.perf_counter() - t

    lk, gk, tk_s = loss_and_grads(FDP91_KERNEL)
    ls, gsim, ts_s = loss_and_grads(simulate)
    if not bool(torch.isfinite(lk)) or not torch.equal(lk, ls):
        fail(f"pallas loss {lk.item()} != simulate loss {ls.item()}")
    for name, a, b in zip(names, gk, gsim):
        if not torch.equal(a, b):
            fail(f"pallas != simulate gradient of {name}: max |diff| "
                 f"{(a - b).abs().max().item()}")
    log(f"{TRAIN_LAYERS}-layer full-width dbrx-132b, batch 1 x seq 4: loss and all "
        f"{len(names)} gradients in pallas mode torch.equal simulate mode ({tk_s:.3f} s "
        f"kernel path, {ts_s:.3f} s plain path); every site compared whole: no column "
        f"slice was needed (the plain version forms wide outputs a block of columns at a "
        f"time)")
    grads_eq = {"kernel_s": tk_s, "plain_s": ts_s, "gradients": len(names)}
    del params, leaves, gk, gsim
    torch.cuda.empty_cache()

    # -- 11. the fault-tolerant Trainer on the card ---------------------------
    rcfg = get_config("dbrx-132b").reduced()
    ropt = adamw(lr=1e-3, state_quant={"mu": qcfg, "nu": qcfg})
    rstep = make_train_step(rcfg, ropt, remat="none", numerics_policy=FDP91_KERNEL)
    rdata = SyntheticLM(rcfg.vocab_size, 16, 4, seed=0, device=dev)
    injected = []

    def injector(step):
        if step == 2 and not injected:
            injected.append(step)
            raise InjectedFailure("injected failure at step 2")

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, inj in (("injected", injector), ("clean", None)):
            trainer = Trainer(rcfg, ropt, lambda s: rdata.batch(s).as_dict(), rstep,
                              os.path.join(tmp, name), save_every=2, failure_injector=inj,
                              device=dev)
            runs[name] = (trainer.run(5)[0], trainer.restarts)
    if injected != [2] or runs["injected"][1] != 1:
        fail(f"the injected run restarted {runs['injected'][1]} times (want 1)")
    if runs["clean"][1] != 0:
        fail(f"a run without an injected failure restarted {runs['clean'][1]} times")
    for a, b in zip(runs["injected"][0].parameters(), runs["clean"][0].parameters()):
        if not torch.equal(a, b):
            fail("the Trainer that recovered from the failure ended on other parameters")
    log(f"Trainer ({rcfg.name}, {FDP91_KERNEL.name}, checkpoints every 2 steps): an "
        f"injected failure at step 2, 1 restart, final parameters torch.equal to a run "
        f"without the failure (0 restarts)")
    del runs

    # -- 12. the seed-order kernel (impl="loop") against plain and vector ------
    F3 = AccumulatorSpec(ovf=9, msb=6, lsb=-20)          # the paper's Fig.-3 pick
    SEED_TILE = D.GemmPlan(32, 32, 128)

    def operands_2d(M, Kd, N, fmt, a_scale=1.0, b_scale=1.0, positive=False,
                    strided=False):
        if strided:                                      # transposed views of both
            a = (torch.randn(Kd, M, generator=gen, device=dev) * a_scale).T
            b = (torch.randn(N, Kd, generator=gen, device=dev) * b_scale).T
        else:
            a = torch.randn(M, Kd, generator=gen, device=dev) * a_scale
            b = torch.randn(Kd, N, generator=gen, device=dev) * b_scale
        if positive:
            a, b = a.abs(), b.abs()
        return on_grid(fmt, a, b)

    LOOP_SHAPES = {"bench hot shape": ((256, 1024, 256), SEED_TILE),
                   "qwen lm_head decode": ((BATCH, d, V), None),
                   "qwen mlp_in prefill": ((BATCH * PROMPT, d, f), None)}
    loop_cases = [
        ("fp32 91-bit ragged", (5, 70, 9), FP32, P91, SEED_TILE, {}),
        ("bf16 91-bit ragged", (17, 300, 33), BF16, P91, SEED_TILE, {}),
        ("posit16_1 91-bit", (4, 64, 40), POSIT16_1, P91, SEED_TILE, {}),
        ("fp32 rne", (4, 200, 40), FP32, RNE, SEED_TILE, {}),
        ("fp32 saturate <2,4,-20>", (4, 200, 40), FP32, SAT, SEED_TILE, {"a_scale": 4.0}),
        ("fp32 <9,6,-20>", (24, 96, 40), FP32, F3, SEED_TILE, {}),
        ("fp32 strided (transposed) a and b, ragged tiles", (37, 150, 45), FP32, P91,
         D.GemmPlan(16, 16, 64), {"strided": True}),
        ("fp32 K = 1000 past bk = 128, so carries normalize 8 times", (40, 1000, 24), FP32,
         P91, SEED_TILE, {}),
        (f"fp32 K = SAFE_CHUNK + 700 positive, bk = SAFE_CHUNK", (3, SAFE_CHUNK + 700, 16),
         FP32, P91, D.GemmPlan(8, 8, 1 << 20), {"positive": True}),
    ] + [(name, shape, FP32, P91, plan, {"b_scale": shape[1] ** -0.5})
         for name, (shape, plan) in LOOP_SHAPES.items()]
    K.fdp_gemm_looped.launches = 0
    loop_err, loop_sites = 0.0, {}
    for name, (M, Kd, N), fmt, spec, plan, kw in loop_cases:
        a, b = operands_2d(M, Kd, N, fmt, **kw)
        want = K.fdp_gemm_plain(a[None], b[None], spec=spec, fmt=fmt)[0]
        got = ops.fdp_gemm(a, b, spec=spec, fmt=fmt, plan=plan, impl="loop")
        vec = ops.fdp_gemm(a, b, spec=spec, fmt=fmt, plan=plan)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"seed-order kernel != plain for {name} {(M, Kd, N)}: max |diff| {err}")
        if not torch.equal(got, vec):
            fail(f"seed-order kernel != vector kernel for {name} {(M, Kd, N)}")
        loop_err = max(loop_err, err)
        fitted = ops.resolve_plan(plan, M, N, Kd)
        extra = f", {n_saturated(got, spec)} outputs saturated" if spec is SAT else ""
        log(f"seed-order kernel == plain == vector kernel (torch.equal): {name} "
            f"{(M, Kd, N)} {fmt.name} {spec.describe()}, plan {fitted.tile}{extra}")
        if name in LOOP_SHAPES:
            ops_n = K.int32_ops(M * Kd, Kd * N, M * Kd * N)
            loop_sites[name] = {
                "shape": [M, Kd, N], "plan": list(fitted.tile),
                "ms": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=P91, plan=plan,
                                                          impl="loop"), reps=10),
                "vector_ms": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=P91, plan=plan),
                                     reps=10),
                "plain_ms": cuda_ms(torch, lambda: K.fdp_gemm_plain(a[None], b[None], spec=P91,
                                                                    fmt=FP32), reps=1),
                # the 3-limb <9,6,-20> on the same inputs: both kernels run
                # their smallest (6-limb) instantiation
                "ms_fig3": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=F3, plan=plan,
                                                               impl="loop"), reps=10),
                "vector_ms_fig3": cuda_ms(torch, lambda: ops.fdp_gemm(a, b, spec=F3, plan=plan),
                                          reps=10),
                **bound(4 * (M * Kd + Kd * N + M * N), ops_n)}
            r = loop_sites[name]
            log(f"  {name}: seed-order kernel {r['ms']:.4f} ms, vector kernel "
                f"{r['vector_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms; bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of the seed-order kernel; at "
                f"{F3.describe()}: seed-order {r['ms_fig3']:.4f} ms, vector "
                f"{r['vector_ms_fig3']:.4f} ms")
        del a, b, want, got, vec
    loop_launches = K.fdp_gemm_looped.launches
    if loop_launches <= 0:
        fail("the seed-order kernel was never launched")
    log(f"seed-order kernel launches {loop_launches} in phase 12 ({len(loop_cases)} checks "
        f"and the timing repeats)")
    torch.cuda.empty_cache()

    # -- 13. the generator: native, simulate and pallas targets --------------
    from repro_torch.core import metrics
    from repro_torch.core.generator import generate_gemm
    import numpy as np

    rng = np.random.default_rng(0)
    gen_runs = {}
    for shape_name, (M, Kd, N) in (("quickstart", (64, 256, 32)),
                                   ("qwen mlp_in prefill", (BATCH * PROMPT, d, f))):
        an = rng.standard_normal((M, Kd)).astype(np.float32)
        bn = rng.standard_normal((Kd, N)).astype(np.float32)
        ref64 = an.astype(np.float64) @ bn.astype(np.float64)
        a, b = torch.from_numpy(an).to(dev), torch.from_numpy(bn).to(dev)
        for spec in (P91, F3):
            outs = {}
            for target, tile in (("native", None), ("simulate", None),
                                 ("pallas", (32, 32, 128)), ("pallas", None)):
                g = generate_gemm(None if target == "native" else spec, FP32, target, tile)
                log(g.report.describe())
                outs[(target, tile)] = g.fn(a, b)
            torch.cuda.synchronize()
            sim = outs[("simulate", None)]
            for tile in ((32, 32, 128), None):
                if not torch.equal(outs[("pallas", tile)], sim):
                    fail(f"generate_gemm pallas (tile {tile}) != simulate at {shape_name} "
                         f"{(M, Kd, N)} {spec.describe()}")
            bits = {t: metrics.correct_bits(o, ref64) for (t, _), o in outs.items()}
            gen_runs[f"{shape_name} {spec.describe()}"] = {
                t: {"median_correct_bits": float(np.median(v)), "min_correct_bits":
                    float(v.min())} for t, v in bits.items()}
            log(f"generate_gemm at {shape_name} {(M, Kd, N)}, {spec.describe()}: pallas "
                f"(tile (32, 32, 128) and plan_gemm's) torch.equal simulate; correct bits "
                f"against an f64 product, median/min: "
                + "; ".join(f"{t} {float(np.median(v)):.1f}/{float(v.min()):.1f}"
                            for t, v in bits.items()))

    # -- 14. qwen3-0.6b at full width, served under a PrecisionPlan from JSON --
    from repro_torch.numerics import PrecisionPlan, SitePlan
    from repro_torch.train.optimizer import state_quant_from_policy

    kernel_cfg = D.GemmConfig(FP32, P91, "pallas")
    plan = PrecisionPlan(
        name="qwen3-0.6b fig3 mlp", default=kernel_cfg,
        sites=tuple(SitePlan(s, D.GemmConfig(FP32, F3, "pallas"))
                    for s in ("mlp_in", "mlp_gate", "mlp_out"))
        + (SitePlan("lm_head", D.GemmConfig(FP32, None, "native")),))
    with tempfile.TemporaryDirectory() as tmp:
        plan_path = os.path.join(tmp, "qwen3_0p6b_fig3.json")
        plan.save(plan_path)
        plan_policy = D.policy_from_plan(plan_path)       # the model gets it from the file
    log("precision plan saved and loaded back:\n" + plan.describe())
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    params = init(cfg, seed=0, device=dev)

    def serve_under(policy):
        with D.use_policy(policy):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = serve(cfg, params, prompts, GEN, device=dev)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

    launched_at: dict = {}
    last = [0]

    def attribute_launches(site_key, cfg_, a_, b_, out_):
        n = K.fdp_gemm.launches
        launched_at[site_key] = launched_at.get(site_key, 0) + n - last[0]
        last[0] = n

    D.reset_sites_seen()
    K.fdp_gemm.launches = 0
    remove_hook = D.add_trace_hook(attribute_launches)
    try:
        plan_toks, first_s = serve_under(plan_policy)
    finally:
        remove_hook()
    plan_launches = K.fdp_gemm.launches
    calls = D.site_calls()
    pallas_sites = sorted(s for s in calls if plan_policy.lookup(s).mode == "pallas")
    n_pallas = sum(calls[s] for s in pallas_sites)
    if any("@bwd" in s for s in calls):
        fail(f"a forward-only serve dispatched backward sites: {sorted(calls)}")
    if "lm_head" not in calls or plan_policy.lookup("lm_head").mode != "native":
        fail(f"lm_head did not dispatch natively: {calls}")
    if plan_launches <= 0 or plan_launches != n_pallas:
        fail(f"dense kernel launches {plan_launches} != dispatches at the plan's pallas "
             f"sites {n_pallas}")
    if launched_at.get("lm_head", 0) != 0 or any(launched_at.get(s) != calls[s]
                                                  for s in pallas_sites):
        fail(f"launches by site {launched_at} != pallas dispatches {calls}")
    plan_s = []
    for _ in range(SERVE_RUNS):
        again, dt = serve_under(plan_policy)
        if not torch.equal(again, plan_toks):
            fail("plan-served tokens differ between runs")
        plan_s.append(dt)
    plan_med = sorted(plan_s)[len(plan_s) // 2]
    plan_serve = {"launches": plan_launches, "calls": calls, "first_serve_s": first_s,
                  "serve_s": plan_s, "tok_s": BATCH * GEN / plan_med,
                  "fdp91_kernel_tok_s": qwen["tok_s"], "fp32_tok_s": qwen["fp32_tok_s"]}
    log(f"serve qwen3-0.6b ({cfg.n_layers} layers, full width) under the plan "
        f"{plan_policy.name!r} from JSON: dense kernel launches {plan_launches} == "
        f"dispatches at its pallas sites {n_pallas} (by site, from a trace hook: "
        + ", ".join(f"{s} {launched_at.get(s, 0)}" for s in sorted(calls))
        + "); lm_head native, 0 launches; no @bwd site")
    log(f"  seconds per serve (after a first, hooked serve of {first_s:.3f} s): "
        f"{', '.join(f'{x:.3f}' for x in plan_s)}; median {plan_med:.3f} s = "
        f"{plan_serve['tok_s']:.2f} tok/s, beside {qwen['tok_s']:.2f} under "
        f"{FDP91_KERNEL.name} and {qwen['fp32_tok_s']:.2f} under {D.MXU_FP32.name} "
        f"(phase 3, this run); tokens repeat across runs")
    del params
    torch.cuda.empty_cache()

    def simulate_twin(policy):
        swap = lambda c: dataclasses.replace(c, mode="simulate") if c.mode == "pallas" else c
        return dataclasses.replace(policy, default=swap(policy.default),
                                   overrides=tuple((p, swap(c)) for p, c in policy.overrides),
                                   name=policy.name + "/simulate")

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = init(cfg2, seed=0, device=dev)
    batch = {"tokens": torch.randint(0, cfg2.vocab_size, (BATCH, PROMPT),
                                     generator=torch.Generator().manual_seed(2)).to(dev)}
    with torch.no_grad():
        logits = {}
        for name, pol in (("plan", plan_policy), ("twin", simulate_twin(plan_policy)),
                          ("fp32", D.MXU_FP32)):
            with D.use_policy(pol):
                t = time.perf_counter()
                logits[name] = forward(params, cfg2, batch)
                torch.cuda.synchronize()
                log(f"  2-layer forward under {pol.name}: {time.perf_counter() - t:.3f} s")
    if not bool(torch.isfinite(logits["plan"][..., :cfg2.vocab_size]).all()):
        fail("plan logits are not finite")
    if not torch.equal(logits["plan"], logits["twin"]):
        fail(f"plan logits != its simulate twin's: max |diff| "
             f"{(logits['plan'] - logits['twin']).abs().max().item()}")
    top1 = metrics.top1_agreement(logits["plan"][..., :cfg2.vocab_size],
                                  logits["fp32"][..., :cfg2.vocab_size])
    plan_serve["top1_vs_fp32_2layer"] = top1
    log(f"2-layer full-width qwen3-0.6b {tuple(batch['tokens'].shape)}: logits under the "
        f"plan torch.equal its simulate twin; top-1 agreement with native fp32 {top1:.4f}")
    del params, logits
    torch.cuda.empty_cache()

    # -- 15. the checked-in zoo plan, unchanged, at full width ----------------
    zoo_path = os.path.join(ROOT, "examples", "plans", "qwen3_0p6b.json")
    zoo_policy = D.policy_from_plan(zoo_path)
    params = init(cfg, seed=0, device=dev)
    all_kernels = (K.fdp_gemm, K.fdp_ragged_gemm, K.fdp_ragged_dw, K.fdp_gemm_looped)
    D.reset_sites_seen()
    for w in all_kernels:
        w.launches = 0
    zoo_toks, zoo_s = serve_under(zoo_policy)
    zoo_calls = D.site_calls()
    if not zoo_calls or any(w.launches for w in all_kernels):
        fail(f"the zoo plan launched FDP kernels {[w.launches for w in all_kernels]} "
             f"(dispatches {zoo_calls})")
    squant = state_quant_from_policy(zoo_policy)
    if squant is None or {m: c.tag() for m, c in squant.items()} != {"mu": "q8b64",
                                                                     "nu": "q8b64"}:
        fail(f"state_quant_from_policy of the zoo plan: {squant}")
    zoo_serve = {"serve_s": zoo_s, "tok_s": BATCH * GEN / zoo_s, "calls": zoo_calls,
                 "state_quant": {m: c.tag() for m, c in squant.items()}}
    log(f"serve qwen3-0.6b at full width under the zoo plan {zoo_policy.name!r} "
        f"(examples/plans/qwen3_0p6b.json, unchanged): {zoo_s:.3f} s = "
        f"{zoo_serve['tok_s']:.2f} tok/s, {sum(zoo_calls.values())} native dispatches, 0 FDP "
        f"launches; state_quant_from_policy: "
        + ", ".join(f"{m}={c.tag()}" for m, c in sorted(squant.items())))
    del params
    torch.cuda.empty_cache()

    moe_in = ragged_sites["moe_in"]
    dw_in = dw_sites["moe_in"]
    hot = loop_sites["bench hot shape"]
    print(json.dumps({"kernels": [{
        "name": "fdp_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_gemm.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:65",
        "launches": (qwen["launches"]["fdp_gemm"] + dbrx["launches"]["fdp_gemm"]
                     + train["launches"]["fdp_gemm"]),
        "launches_by_path": {"qwen3-0.6b serve": qwen["launches"]["fdp_gemm"],
                             "dbrx-132b serve": dbrx["launches"]["fdp_gemm"],
                             "dbrx-132b train step": train["launches"]["fdp_gemm"]},
        "max_abs_err": max_err,
        "ms": lm["ms"], "plain_ms": lm["plain_ms"], "bound_ms": lm["bound_ms"],
        "bound_by": lm["bound_by"], "library_ms": None,
        "at": f"qwen3-0.6b lm_head {tuple(lm['shape'])} fp32 {P91.describe()}",
        "mlp_in": mi, "router_2d": {**router, "launches": dbrx["calls"]["moe_router"]},
        "serve_kernel_s_estimate": qwen["kernel_s_estimate"],
        "serve_trace": qwen["trace"],
    }, {
        "name": "fdp_ragged_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_ragged_gemm.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:282",
        "launches": dbrx["launches"]["fdp_ragged_gemm"] + train["launches"]["fdp_ragged_gemm"],
        "launches_by_path": {"dbrx-132b serve": dbrx["launches"]["fdp_ragged_gemm"],
                             "dbrx-132b train step": train["launches"]["fdp_ragged_gemm"]},
        "max_abs_err": ragged_err,
        "ms": moe_in["ms"], "plain_ms": moe_in["plain_ms"], "bound_ms": moe_in["bound_ms"],
        "bound_by": moe_in["bound_by"], "library_ms": None,
        "at": f"dbrx-132b moe_in decode {tuple(moe_in['shape'])} groups "
              f"{moe_in['groups']} fp32 {P91.describe()}",
        "sites": ragged_sites,
        "dbrx_serve": {k: v for k, v in dbrx.items() if k != "trace"},
        "dbrx_serve_trace": dbrx["trace"], "dbrx_1layer_pallas_vs_simulate": dbrx_eq,
    }, {
        "name": "fdp_ragged_dw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_ragged_dw.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:363",
        "launches": train["launches"]["fdp_ragged_dw"],
        "launches_by_path": {"dbrx-132b train step": train["launches"]["fdp_ragged_dw"]},
        "max_abs_err": dw_err,
        "ms": dw_in["ms"], "plain_ms": dw_in["plain_ms"], "bound_ms": dw_in["bound_ms"],
        "bound_by": dw_in["bound_by"], "library_ms": None,
        "at": f"dbrx-132b moe_in@bwd.dB {tuple(dw_in['shape'])} groups {dw_in['groups']} "
              f"fp32 {P91.describe()}; plain_ms on {dw_in['plain_at']}",
        "sites": dw_sites,
        "dbrx_train": train, "dbrx_1layer_grads_pallas_vs_simulate": grads_eq,
    }, {
        "name": "fdp_gemm_looped", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_gemm_looped.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:103",
        "launches": loop_launches,
        "launches_by_path": {"seed-order vs vector comparison (phase 12)": loop_launches},
        "max_abs_err": loop_err,
        "ms": hot["ms"], "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"], "library_ms": None,
        "at": f"bench hot shape {tuple(hot['shape'])} at the seed tile {tuple(hot['plan'])} "
              f"fp32 {P91.describe()}",
        "shapes": loop_sites, "generator": gen_runs,
        "qwen_plan_serve": plan_serve, "qwen_zoo_plan_serve": zoo_serve,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
