#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card (nvidia-smi name and power limit); build the FDP GEMM kernel
     from ``src/repro_torch/kernels/csrc/fdp_gemm.cu`` and print the seconds;
  2. the kernel against its plain PyTorch version on the card, torch.equal,
     over formats, round/overflow modes, ragged and broadcast shapes, a K
     long enough that carries normalize inside the kernel's K loop, and the
     full-width decode shapes of qwen3-0.6b;
  3. qwen3-0.6b at full width served (4 prompts x 16 tokens, 16 generated)
     under the 91-bit FDP kernel policy, with the kernel's launch count
     read around the first run and held against the FDP dispatches; then
     timing repeats in turns with the same serve under native fp32, the
     cost yardstick; then one serve of each policy under torch.profiler,
     for the device's busy and idle time and the kernels' summed time;
  4. a 2-layer cut of the same model: forward logits in ``pallas`` mode
     (kernel) torch.equal to ``simulate`` mode (plain);
  5. one JSON line of per-kernel numbers, then the ``ok`` line.

The bound of a kernel time is the larger of its bytes (inputs read once,
output written once) over 3.35 TB/s (H100 SXM HBM3, NVIDIA data sheet) and
the int32 operations the function needs (``fdp_gemm.int32_ops``: one decode
per distinct operand element, 20 operations per product) over the card's
int32 rate: 132 SMs x 64 INT32 lanes (Hopper white paper) x 1.98 GHz (max SM
clock) = 16.73e12 op/s.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BATCH, PROMPT, GEN = 4, 16, 16
SERVE_RUNS = 3


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


def trace_serve(torch, serve_once) -> dict:
    """Run one serve under torch.profiler and read its device timeline:
    busy seconds (union of all device events), idle share of the trace's
    span, and the summed seconds and count of the FDP GEMM kernel; None
    when the profiler saw no device event."""
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
    fdp = [e for e in dev_events if "fdp_gemm_kernel" in e.name]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_s": wall, "span_s": span_us / 1e6, "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / span_us, "device_events": len(dev_events),
            "fdp_kernels": len(fdp),
            "fdp_kernel_s": sum(e.time_range.elapsed_us() for e in fdp) / 1e6,
            "top": [(name[:60], us / 1e6) for name, us in top]}


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
    from repro_torch.launch.serve import FDP91_KERNEL, serve
    from repro_torch.models import forward, init

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
    K.load()
    log(f"built and loaded the FDP GEMM kernel in {time.perf_counter() - t0:.2f} s")

    # -- 2. kernel vs plain version on the card ------------------------------
    P91 = AccumulatorSpec.paper_91bit()
    RNE = AccumulatorSpec(30, 30, -30, round_mode="rne")
    SAT = AccumulatorSpec(2, 4, -20, overflow_mode="saturate")
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(B, M, Kd, N, fmt, a_scale=1.0, b_scale=1.0, bcast=False,
                 positive=False):
        a = torch.randn(B, M, Kd, generator=gen, device=dev) * a_scale
        b = torch.randn(1 if bcast else B, Kd, N, generator=gen, device=dev) * b_scale
        if positive:
            a, b = a.abs(), b.abs()
        if isinstance(fmt, PositFormat):
            a, b = fmt.from_float(a), fmt.from_float(b)
        else:
            a, b = fmt.quantize(a), fmt.quantize(b)
        return a, (b.expand(B, Kd, N) if bcast else b)

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
        extra = ""
        if spec is SAT:
            # the register's extremes, rounded to f32 as the read-out does
            hi = torch.tensor((2 ** (spec.width - 1) - 1) * 2.0 ** spec.lsb).float()
            lo = -(2 ** (spec.width - 1)) * 2.0 ** spec.lsb
            n_sat = int(((got == hi.item()) | (got == lo)).sum())
            if n_sat == 0:
                fail("the saturate case never saturated")
            extra = f", {n_sat} outputs saturated"
        max_err = max(max_err, err)
        log(f"kernel == plain (torch.equal): {name} {(B, M, Kd, N)} "
            f"{fmt.name} {spec.describe()}{extra}")

    # -- 3. serve qwen3-0.6b at full width -----------------------------------
    params = init(cfg, seed=0, device=dev)
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
    K.fdp_gemm.launches = 0
    toks, dt = timed_serve(FDP91_KERNEL)
    launches = K.fdp_gemm.launches
    calls = D.site_calls()
    n_fdp = sum(calls.values())
    if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"served tokens malformed: shape {tuple(toks.shape)}")
    if launches <= 0 or launches != n_fdp:
        fail(f"kernel launches {launches} != FDP dispatches {n_fdp}")
    if set(calls) != set(SITES):
        fail(f"dispatched sites {sorted(calls)} != {sorted(SITES)}")
    # an estimate of the serve's kernel time: per-site CUDA-event means of
    # warm back-to-back launches, times the serve's calls (the trace below
    # measures it inside the serve)
    spec_ms = {}
    for site, (B, M, Kd, N) in SITES.items():
        a, b = operands(B, M, Kd, N, FP32, b_scale=Kd ** -0.5, bcast=site in weight_sites)
        spec_ms[site] = cuda_ms(torch, lambda: K.fdp_gemm(a, b, spec=P91, fmt=FP32),
                                reps=20 if site == "lm_head" else 50)
    kernel_ms = sum(calls[s] * spec_ms[s] for s in SITES)
    # timing repeats, FDP and fp32 in turns; the FDP tokens must repeat
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
    log(f"serve {cfg.name} ({cfg.n_layers} layers, d {d}, vocab {cfg.vocab_size}) "
        f"under {FDP91_KERNEL.name}: batch {BATCH} prompt {PROMPT} gen {GEN}; "
        f"kernel launches {launches} == FDP dispatches {n_fdp} (first run)")
    log(f"  seconds per serve, {SERVE_RUNS} runs: {', '.join(f'{x:.3f}' for x in fdp_s)}; "
        f"median {med:.3f} s = {BATCH * GEN / med:.2f} tok/s")
    log(f"estimate (per-site CUDA-event means x calls, not a trace): kernel "
        f"{kernel_ms / launches:.4f} ms per launch, {kernel_ms / 1e3:.3f} s per serve "
        f"= {100 * kernel_ms / 1e3 / med:.1f}% of the median serve")
    for site in SITES:
        log(f"  {site:9s} {str(SITES[site]):24s} calls {calls[site]:5d} "
            f"{spec_ms[site]:.4f} ms/launch")
    for name, t in traces.items():
        if t is None:
            log(f"traced serve under {name}: torch.profiler recorded no device "
                f"events, so device busy time and idle share are not measured")
            continue
        log(f"traced serve under {name} (torch.profiler): wall {t['wall_s']:.3f} s, "
            f"trace span {t['span_s']:.3f} s, device busy {t['device_busy_s']:.3f} s, "
            f"idle share {100 * t['idle_share']:.1f}%, {t['device_events']} device "
            f"events, FDP GEMM kernels {t['fdp_kernels']} (FDP dispatches "
            f"{n_fdp if name == FDP91_KERNEL.name else 0}) summing {t['fdp_kernel_s']:.3f} s")
        log(f"  top device time: " + "; ".join(f"{n} {x:.3f} s" for n, x in t["top"]))
    log(f"sample tokens: {toks[0].tolist()}")
    agree = float((toks32 == toks).float().mean())
    log(f"serve under {D.MXU_FP32.name} (native fp32 matmul, the yardstick), "
        f"{SERVE_RUNS} runs: {', '.join(f'{x:.3f}' for x in fp32_s)}; median "
        f"{med32:.3f} s = {BATCH * GEN / med32:.2f} tok/s; FDP/fp32 = {med / med32:.2f}x; "
        f"greedy tokens agree on {100 * agree:.1f}%")
    del params

    # -- 4. kernel path vs plain path at model level -------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = init(cfg2, seed=0, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                     generator=torch.Generator().manual_seed(2)).to(dev)}
    simulate = D.NumericsPolicy(dataclasses.replace(FDP91_KERNEL.default, mode="simulate"))
    with torch.no_grad():
        with D.use_policy(FDP91_KERNEL):
            t = time.perf_counter()
            lk = forward(params2, cfg2, batch)
            torch.cuda.synchronize()
            tk = time.perf_counter() - t
        with D.use_policy(simulate):
            t = time.perf_counter()
            ls = forward(params2, cfg2, batch)
            torch.cuda.synchronize()
            ts = time.perf_counter() - t
    if lk.shape != (BATCH, PROMPT, V) or not bool(torch.isfinite(lk[..., :cfg.vocab_size]).all()):
        fail(f"forward logits malformed: {tuple(lk.shape)}")
    if not torch.equal(lk, ls):
        fail(f"pallas != simulate logits at 2 layers: max |diff| "
             f"{(lk - ls).abs().max().item()}")
    log(f"2-layer full-width forward {tuple(batch['tokens'].shape)}: pallas logits "
        f"torch.equal simulate logits ({tk:.3f} s kernel path, {ts:.3f} s plain path)")
    del params2

    # -- 5. per-kernel numbers -----------------------------------------------
    def at_shape(site):
        B, M, Kd, N = SITES[site]
        a, b = operands(B, M, Kd, N, FP32, b_scale=Kd ** -0.5, bcast=True)
        products = B * M * Kd * N
        nbytes = 4 * (B * M * Kd + Kd * N + B * M * N)   # weight read once
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops = K.int32_ops(B * M * Kd, Kd * N, products)  # weight decoded once
        ops_ms = ops / INT32_OPS_PER_S * 1e3
        plain_ms = cuda_ms(torch, lambda: K.fdp_gemm_plain(a, b, spec=P91, fmt=FP32),
                           reps=2)
        return {"shape": [B, M, Kd, N], "ms": spec_ms[site], "plain_ms": plain_ms,
                "int32_ops_per_product": ops / products,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}

    lm, mi = at_shape("lm_head"), at_shape("mlp_in")
    for site, r in (("lm_head", lm), ("mlp_in", mi)):
        log(f"bound at {site}: {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['int32_ops_per_product']:.4f} int32 ops/product at "
            f"{INT32_OPS_PER_S:.4g} op/s, bytes at {HBM_BYTES_PER_S:.3g} B/s); "
            f"kernel {r['ms']:.4f} ms = {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    print(json.dumps({"kernels": [{
        "name": "fdp_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_gemm.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:65",
        "launches": launches, "max_abs_err": max_err,
        "ms": lm["ms"], "plain_ms": lm["plain_ms"], "bound_ms": lm["bound_ms"],
        "bound_by": lm["bound_by"], "library_ms": None,
        "at": f"lm_head {tuple(lm['shape'])} fp32 {P91.describe()}",
        "mlp_in": mi, "serve_kernel_s_estimate": kernel_ms / 1e3,
        "serve_trace": {name: t and {k: v for k, v in t.items() if k != "top"}
                        for name, t in traces.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
