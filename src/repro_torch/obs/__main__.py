"""``python -m repro_torch.obs`` — dump the process metrics registry (the
counterpart of ``python -m repro.obs``, with the same output).

Default output is the Prometheus text exposition; ``--json`` emits the JSON
snapshot. A fresh interpreter has an empty registry, so this entry point is
mostly useful embedded after in-process work (``python -m repro_torch.obs
--demo`` shows the formats on a tiny synthetic workload).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.registry import default_registry


def _demo(reg) -> None:
    c = reg.counter("repro_demo_requests_total", "demo requests",
                    ("workload", "outcome"))
    c.inc(3, workload="chat", outcome="completed")
    c.inc(1, workload="chat", outcome="rejected")
    g = reg.gauge("repro_demo_live_requests", "demo live requests")
    g.set(2)
    h = reg.histogram("repro_demo_latency_seconds", "demo latency",
                      ("workload",))
    for v in (0.004, 0.011, 0.270):
        h.observe(v, workload="chat")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="dump the repro_torch.obs metrics registry")
    ap.add_argument("--json", action="store_true",
                    help="JSON snapshot instead of Prometheus text")
    ap.add_argument("--out", default=None,
                    help="write to this path instead of stdout")
    ap.add_argument("--demo", action="store_true",
                    help="populate a few demo metrics first (format tour)")
    args = ap.parse_args(argv)

    reg = default_registry()
    if args.demo:
        _demo(reg)
    text = reg.snapshot_json() + "\n" if args.json else reg.exposition()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
