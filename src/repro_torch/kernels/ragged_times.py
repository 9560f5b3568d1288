"""Device times of the sorted-segment kernels (the forward and the weight
gradient) at the main path's calls, for holding two checkouts of the port
side by side on one card.

    python -m repro_torch.kernels.ragged_times [--reps N] [--routings]
    python -m repro_torch.kernels.ragged_times --dw [--reps N]

For each call it prints one JSON line: the shapes of ``x (T, d)`` and ``w
(E, d, f)``, the group sizes, and at the paper's 91-bit <30,30,-30> and at
<9,6,-20> on the same inputs the mean milliseconds a call of warm
back-to-back calls (CUDA events) and the kernel's own mean device time a
launch (``torch.profiler``); the card, and the file of the wrapper it
timed. The calls are dbrx-132b's at full width: moe_in and moe_out at a
decode step (4 tokens routed top-4 of 16 experts: 16 rows), and at a
training step (4 x 64 tokens: 1024 rows) moe_in's forward and its dX, the
same contraction of the output gradient against the transposed expert
weights (``w.transpose(-1, -2)``, a view), as ``core.dispatch`` makes it.
Group sizes come from ``routed_sizes`` (``chip_smoke.py`` draws the same),
the inputs from a seeded generator on the card.

``--routings`` then times, at 91 bits, moe_in's decode shape (16 rows, 16
experts) on one x and w under other routings of its 16 rows, and prints one
more JSON line: every routing forms the same 16 x d x f products, but the
experts whose weights it reads differ. 16 groups of 1 row read 16 experts,
each by one row tile; 8 groups of 2 read 8, each by 2 row tiles; 1 group
of 16 reads one, by 16 row tiles. If the row tiles of a group share its
weight tiles through L2, DRAM reads 8 and 1 experts' weights there, not
16; if the weight stream bounds the kernel, that shows as a shorter time.
No rows routed (every group empty) launches the same grid with no
products: every block returns or writes zeros, which is the most the
grid's padding to ceil(T / BM) + E row tiles can cost.

``--dw`` times the weight-gradient kernel instead, the same way (one JSON
line a call, both specs): ``fdp_ragged_dw(x, g, group_sizes, ...)`` at the
three weight gradients of a dbrx-132b training step (moe_in's and
moe_gate's, x (1024, d) and g (1024, f); moe_out's, x (1024, f) and g
(1024, d); 1024 rows in 16 groups, as ``chip_smoke.py`` routes them), then
at moe_in's shape with no rows routed (every output reads out a zero
register: the read-out and store floor) and with one row a group (one
product an output beside a full read-out).

Without ``--routings`` it calls only ``fdp_ragged_gemm(x, w, group_sizes,
spec=..., fmt=...)`` (``--dw``: ``fdp_ragged_dw(x, g, group_sizes, spec=...,
fmt=...)``), the configs and ``dense_times``' timers, which every version of
the port since the dense kernel's redesign has: copied with
``dense_times.py`` into another checkout's ``src/repro_torch/kernels/`` and
run there with that checkout's ``src`` on ``PYTHONPATH``, it times that
checkout's kernel on the same inputs.
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
from repro_torch.kernels.dense_times import cuda_ms, device_ms

SYMBOL = "fdp_ragged_gemm_kernel"
DW_SYMBOL = "fdp_ragged_dw_kernel"
DECODE_TOKENS, TRAIN_TOKENS = 4, 4 * 64


def routed_sizes(tokens: int, n_experts: int, top_k: int, seed: int) -> list:
    """Group sizes of top-k routing with each token's k experts drawn at
    random (``torch.randperm`` from ``seed``), as a router with random
    weights spreads them."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randperm(n_experts, generator=g)[:top_k] for _ in range(tokens)])
    return torch.bincount(ids.reshape(-1), minlength=n_experts).tolist()


def calls() -> list:
    """``(name, T, d, f, group sizes, transposed)`` of each timed call; a
    transposed call contracts (T, f) against the (E, f, d) view of an (E,
    d, f) weight."""
    cfg = get_config("dbrx-132b")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    decode = routed_sizes(DECODE_TOKENS, E, k, seed=3)
    train = routed_sizes(TRAIN_TOKENS, E, k, seed=6)
    return [("dbrx moe_in decode", DECODE_TOKENS * k, d, f, decode, False),
            ("dbrx moe_out decode", DECODE_TOKENS * k, f, d, decode, False),
            ("dbrx moe_in train forward", TRAIN_TOKENS * k, d, f, train, False),
            ("dbrx moe_in train dX", TRAIN_TOKENS * k, d, f, train, True)]


def dw_calls() -> list:
    """``(name, T, d, f, group sizes)`` of each weight gradient ``--dw``
    times: x (T, d) and g (T, f)."""
    cfg = get_config("dbrx-132b")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    T, train = TRAIN_TOKENS * k, routed_sizes(TRAIN_TOKENS, E, k, seed=6)
    return [("dbrx moe_in dW", T, d, f, train), ("dbrx moe_gate dW", T, d, f, train),
            ("dbrx moe_out dW", T, f, d, train),
            ("dbrx moe_in dW, no rows routed", T, d, f, [0] * E),
            ("dbrx moe_in dW, one row a group", T, d, f, [1] * E)]


def routings(n_experts: int) -> dict:
    """Group sizes of ``n_experts`` rows routed to ``n_experts`` experts in
    the ways ``--routings`` times (see the module note)."""
    E = n_experts
    return {"16 groups of 1 row": [1] * E,
            "8 groups of 2 rows": [2, 0] * (E // 2),
            "1 group of 16 rows": [E] + [0] * (E - 1),
            "no rows routed": [0] * E}


def time_routings(dev, gen, reps: int, card) -> dict:
    """The ``--routings`` line: device ms a launch at 91 bits under each
    routing of moe_in's decode shape, on one x and w."""
    cfg = get_config("dbrx-132b")
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = torch.randn(E, d, f, generator=gen, device=dev) * d ** -0.5
    x = torch.randn(E, d, generator=gen, device=dev)
    spec = AccumulatorSpec.paper_91bit()
    row = {"name": "dbrx moe_in decode, routings of 16 rows", "x": list(x.shape),
           "w": list(w.shape)}
    for label, gs in routings(E).items():
        sizes = torch.tensor(gs, dtype=torch.int32, device=dev)
        call = lambda: K.fdp_ragged_gemm(x, w, sizes, spec=spec, fmt=FP32)  # noqa: E731
        row[label] = {"groups": gs, "experts_read": sum(1 for n in gs if n),
                      "device_ms": device_ms(call, reps, SYMBOL)}
    row.update(card=card, kernel_wrapper=K.__file__)
    return row


def main(argv: list) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20,
                    help="calls a time at decode (a tenth, at least 2, at training)")
    ap.add_argument("--routings", action="store_true",
                    help="also time moe_in's decode shape under other routings")
    ap.add_argument("--dw", action="store_true",
                    help="time the weight-gradient kernel instead of the forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1]
    specs = {"91-bit": AccumulatorSpec.paper_91bit(), "<9,6,-20>": AccumulatorSpec(9, 6, -20)}
    gen = torch.Generator(device=dev).manual_seed(0)
    card = card[0] if card else None

    def timed(row: dict, launch, reps: int, symbol: str) -> None:
        """Fill ``row`` with each spec's times of ``launch(spec)`` and print it."""
        for label, spec in specs.items():
            call = lambda: launch(spec)  # noqa: E731
            row[f"ms {label}"] = cuda_ms(call, reps)
            row[f"device_ms {label}"] = device_ms(call, reps, symbol)
        row.update(card=card, kernel_wrapper=K.__file__)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()

    if args.dw:
        for name, T, d, f, gs in dw_calls():
            x = torch.randn(T, d, generator=gen, device=dev)
            g = torch.randn(T, f, generator=gen, device=dev) * f ** -0.5
            sizes = torch.tensor(gs, dtype=torch.int32, device=dev)
            timed({"name": name, "x": list(x.shape), "g": list(g.shape), "groups": gs},
                  lambda spec: K.fdp_ragged_dw(x, g, sizes, spec=spec, fmt=FP32),
                  max(2, args.reps // 10), DW_SYMBOL)
            del x, g
        return
    for name, T, d, f, gs, transposed in calls():
        w = torch.randn(len(gs), d, f, generator=gen, device=dev) * d ** -0.5
        if transposed:
            w = w.transpose(-1, -2)
        x = torch.randn(T, w.shape[1], generator=gen, device=dev)
        sizes = torch.tensor(gs, dtype=torch.int32, device=dev)
        timed({"name": name, "x": list(x.shape), "w": list(w.shape), "groups": gs},
              lambda spec: K.fdp_ragged_gemm(x, w, sizes, spec=spec, fmt=FP32),
              args.reps if T <= 64 else max(2, args.reps // 10), SYMBOL)
        del x, w
    if args.routings:
        print(json.dumps(time_routings(dev, gen, args.reps, card)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
