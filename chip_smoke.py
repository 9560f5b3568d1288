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
  7. one JSON line of per-kernel numbers, then the ``ok`` line.

The bound of a kernel time is the larger of its bytes (inputs read once,
output written once) over 3.35 TB/s (H100 SXM HBM3, NVIDIA data sheet) and
the int32 operations the function needs (``fdp_gemm.int32_ops``: one decode
per distinct operand element, 20 operations per product; for the
sorted-segment kernel, the rows in a group and the weights of the non-empty
groups) over the card's int32 rate: 132 SMs x 64 INT32 lanes (Hopper white
paper) x 1.98 GHz (max SM clock) = 16.73e12 op/s.
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
MOE_LAYERS = 2          # dbrx-132b depth cut: 31.0 GB of f32 parameters
# kernel name -> the substring of its device symbol in a profiler trace
TRACE_NAMES = {"fdp_gemm": "fdp_gemm_kernel", "fdp_ragged_gemm": "fdp_ragged_gemm_kernel"}


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
    moe_in = ragged_sites["moe_in"]
    print(json.dumps({"kernels": [{
        "name": "fdp_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fdp_gemm.cu",
        "replaces": "src/repro/kernels/fdp_gemm.py:65",
        "launches": qwen["launches"]["fdp_gemm"] + dbrx["launches"]["fdp_gemm"],
        "launches_by_path": {"qwen3-0.6b serve": qwen["launches"]["fdp_gemm"],
                             "dbrx-132b serve": dbrx["launches"]["fdp_gemm"]},
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
        "launches": dbrx["launches"]["fdp_ragged_gemm"],
        "launches_by_path": {"dbrx-132b serve": dbrx["launches"]["fdp_ragged_gemm"]},
        "max_abs_err": ragged_err,
        "ms": moe_in["ms"], "plain_ms": moe_in["plain_ms"], "bound_ms": moe_in["bound_ms"],
        "bound_by": moe_in["bound_by"], "library_ms": None,
        "at": f"dbrx-132b moe_in decode {tuple(moe_in['shape'])} groups "
              f"{moe_in['groups']} fp32 {P91.describe()}",
        "sites": ragged_sites,
        "dbrx_serve": {k: v for k, v in dbrx.items() if k != "trace"},
        "dbrx_serve_trace": dbrx["trace"], "dbrx_1layer_pallas_vs_simulate": dbrx_eq,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
