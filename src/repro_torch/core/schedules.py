"""Persisted GemmPlan schedules, the schedule zoo (counterpart of
``repro.core.schedules``).

``plan_gemm(autotune=True)`` measures the dense kernel's candidate launches
on the card and caches the winners in the process-global plan cache, which
forgets them at exit. A ``ScheduleZoo`` snapshots that cache for one
backend, persists it as fingerprinted, schema-versioned JSON (the
reference's schema; a row that names a launch also carries its
``LAUNCH_FIELDS``), and installs it back into the cache, so that a warm
process takes zero plan misses and launches the measured layouts.

Layout: one file per backend under ``src/repro_torch/schedules/<backend>.json``
(``cuda.json``, measured on the card), beside this package, not under
``examples/``. Refresh it on the card with

    PYTHONPATH=src python -m repro_torch.core.schedules --refresh

which serves qwen3-0.6b at full width under the 91-bit kernel policy
(a simple serve and a continuous engine, the shapes ``chip_smoke.py``
serves), autotunes every plan key those serves resolve, prints each key's
model pick beside the winner, and saves the zoo with the card named in its
``meta``. ``launch.serve``, ``launch.train`` and ``python -m
repro_torch.serving`` preload it at startup (``preload_schedules``).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from . import dispatch
from .accumulator import SAFE_CHUNK, AccumulatorSpec
from .dispatch import LAUNCH_FIELDS, GemmPlan

SCHEDULE_VERSION = 1
SCHEDULE_KIND = "repro.core.ScheduleZoo"

# The checked-in location: the port's own artifacts live in the package.
DEFAULT_SCHEDULE_DIR = str(Path(__file__).resolve().parent.parent / "schedules")


def schedule_fingerprint() -> str:
    """Fingerprint of the autotune configuration a zoo file caches results
    for: the candidate set (``AUTOTUNE_TOP`` launches ranked by the dense
    kernel's cost model over its tile table, threads a block and
    shared-memory limit), the carry-headroom bound and the timing
    discipline. Changing any of these invalidates persisted schedules: the
    measurements would no longer mean the same thing. Computed without a
    card."""
    from repro_torch.kernels import fdp_gemm as K
    tiles, resident, smem = K._dense_table()
    cfg = {
        "autotune_top": dispatch.AUTOTUNE_TOP,
        "dense_tiles": sorted((lc, *tiles[lc], resident[lc]) for lc in tiles),
        "dense_threads": K.DENSE_THREADS,
        "dense_smem_limit": smem,
        "dense_cost": (K._WORD, K._DECODE, K._TREE_WORD, K._LEVEL, K._CHUNK),
        "safe_chunk": SAFE_CHUNK,
        "measure": {"reps": dispatch.MEASURE_REPS,
                    "min_seconds": dispatch.MEASURE_MIN_SECONDS},
    }
    blob = json.dumps(cfg, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def default_backend() -> str:
    """The backend an entry point serves on by default: "cuda" where a card
    is present, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _spec_doc(spec: AccumulatorSpec) -> dict:
    return {"ovf": spec.ovf, "msb": spec.msb, "lsb": spec.lsb,
            "round_mode": spec.round_mode,
            "overflow_mode": spec.overflow_mode}


@dataclasses.dataclass
class ScheduleZoo:
    """All persisted schedules for one backend.

    ``entries`` maps the plan-cache problem signature, ``(batch, m, n, k,
    fmt_name, AccumulatorSpec)``, to its ``GemmPlan``. The backend lives on
    the zoo, not the key: schedules measured on one backend say nothing
    about another."""

    backend: str
    entries: dict
    meta: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_cache(cls, backend: Optional[str] = None,
                   meta: Optional[dict] = None) -> "ScheduleZoo":
        """Snapshot the process-global plan cache for ``backend`` (default:
        ``default_backend()``)."""
        backend = backend or default_backend()
        entries = {}
        with dispatch._PLAN_LOCK:
            for key, plan in dispatch._PLAN_CACHE.items():
                batch, m, n, k, fmt_name, spec, be = key
                if be == backend:
                    entries[(batch, m, n, k, fmt_name, spec)] = plan
        return cls(backend=backend, entries=entries, meta=dict(meta or {}))

    def install(self, *, source: str = "persisted") -> int:
        """Install this zoo's schedules into the process-global plan cache
        (marked ``source="persisted"``) and count them in
        ``PlanCacheStats.persisted_loads``. ``register_plan`` overrides are
        never clobbered. Returns the number installed."""
        installed = 0
        with dispatch._PLAN_LOCK:
            for (batch, m, n, k, fmt_name, spec), plan in self.entries.items():
                key = (batch, m, n, k, fmt_name, spec, self.backend)
                cached = dispatch._PLAN_CACHE.get(key)
                if cached is not None and cached.source == "override":
                    continue
                dispatch._PLAN_CACHE[key] = dataclasses.replace(plan, source=source)
                installed += 1
            dispatch._PLAN_SIZE.set(len(dispatch._PLAN_CACHE))
        if installed:
            dispatch._PLAN_OPS.inc(installed, op="persisted_loads")
        return installed

    def save(self, path) -> None:
        """Serialize to versioned JSON (schema and fingerprint headers,
        entries sorted: byte-stable for a given cache state)."""
        rows = []
        for (batch, m, n, k, fmt_name, spec), plan in sorted(
                self.entries.items(),
                key=lambda kv: (kv[0][4], repr(kv[0][5]), kv[0][:4])):
            row = {"batch": batch, "m": m, "n": n, "k": k,
                   "fmt": fmt_name, "spec": _spec_doc(spec),
                   "bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
                   "source": plan.source}
            if plan.launch is not None:
                row.update(zip(LAUNCH_FIELDS, plan.launch))
            rows.append(row)
        doc = {
            "version": SCHEDULE_VERSION,
            "kind": SCHEDULE_KIND,
            "fingerprint": schedule_fingerprint(),
            "backend": self.backend,
            "meta": self.meta,
            "entries": rows,
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path, *, check_fingerprint: bool = True) -> "ScheduleZoo":
        """Load and validate a zoo file. Rejects documents of the wrong
        kind, from a future schema version, or (by default) whose autotune
        configuration no longer matches this build: a stale schedule is a
        measurement of a different search space."""
        with open(path) as f:
            doc = json.load(f)
        kind = doc.get("kind")
        if kind != SCHEDULE_KIND:
            raise ValueError(
                f"{path} is not a schedule zoo (kind={kind!r}, "
                f"expected {SCHEDULE_KIND!r})")
        version = doc.get("version")
        if not isinstance(version, int) or version > SCHEDULE_VERSION:
            raise ValueError(
                f"{path} has schema version {version!r}, this build reads "
                f"<= {SCHEDULE_VERSION}: refusing to guess its semantics")
        fp, want = doc.get("fingerprint"), schedule_fingerprint()
        if check_fingerprint and fp != want:
            raise ValueError(
                f"{path} fingerprint {fp!r} != current autotune config "
                f"{want!r}: the candidate set or timing discipline changed; "
                f"refresh with python -m repro_torch.core.schedules --refresh")
        entries = {}
        for row in doc.get("entries", []):
            spec = AccumulatorSpec(**row["spec"])
            key = (int(row["batch"]), int(row["m"]), int(row["n"]),
                   int(row["k"]), row["fmt"], spec)
            launch = (tuple(int(row[f]) for f in LAUNCH_FIELDS)
                      if LAUNCH_FIELDS[0] in row else None)
            entries[key] = GemmPlan(int(row["bm"]), int(row["bn"]), int(row["bk"]),
                                    source=row.get("source", "persisted"), launch=launch)
        return cls(backend=doc["backend"], entries=entries, meta=doc.get("meta", {}))


def zoo_path(directory: Optional[str] = None, backend: Optional[str] = None) -> str:
    return os.path.join(directory or DEFAULT_SCHEDULE_DIR,
                        f"{backend or default_backend()}.json")


def preload_schedules(directory: Optional[str] = None,
                      backend: Optional[str] = None) -> int:
    """Warm the plan cache from the checked-in schedule zoo for ``backend``
    (default: ``default_backend()``), if a file exists. Returns the number
    of schedules installed (0 when no zoo is checked in for this backend),
    after which a process serving the covered shapes takes zero plan
    misses. Called by the serve and train drivers and the serving CLI at
    startup."""
    path = zoo_path(directory, backend)
    if not os.path.exists(path):
        return 0
    return ScheduleZoo.load(path).install()


# ---------------------------------------------------------------------------
# Refreshing the cuda zoo on the card
# ---------------------------------------------------------------------------
# The serves whose plan keys the zoo covers: qwen3-0.6b at full width under
# the 91-bit kernel policy, a simple serve (batch 4, prompt 16, 16
# generated) and a continuous engine (4 slots, max_len 160).
SERVE_ARCH = "qwen3-0.6b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 16
ENGINE_SLOTS, ENGINE_MAX_LEN = 4, 160


def card_meta(device) -> dict:
    """The card a zoo is measured on: its name, multiprocessors and power
    limit (as ``nvidia-smi`` prints it)."""
    dev = torch.device(device)
    props = torch.cuda.get_device_properties(dev)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"], capture_output=True, text=True, check=True,
        timeout=30).stdout.strip()
    return {"device": props.name, "sms": props.multi_processor_count, "power_limit": power}


def serve_keys(cfg, params, device) -> list:
    """The plan keys (cache keys of ``dispatch._PLAN_CACHE``) that a simple
    serve and a continuous engine of ``cfg`` resolve under the 91-bit
    kernel policy, at the zoo's serve shapes; the plan cache is cleared
    first and holds them after."""
    from repro_torch.launch.batching import ContinuousBatcher, Request
    from repro_torch.launch.serve import FDP91_KERNEL, serve
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen)
    dispatch.clear_plan_cache()
    with dispatch.use_policy(FDP91_KERNEL):
        serve(cfg, params, prompts, SERVE_GEN, device=dev)
    eng = ContinuousBatcher(cfg, params, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                            warmup=FDP91_KERNEL)
    for i, row in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=row.tolist(), max_new=2))
    eng.run()
    with dispatch._PLAN_LOCK:
        return sorted(dispatch._PLAN_CACHE, key=lambda key: (repr(key[5]), key[:4]))


def autotune_keys(keys, log=print) -> list:
    """``plan_gemm(autotune=True)`` on each plan key; logs and returns per
    key the model pick's seconds and launch, the winner's, the winner's
    rank by the cost model and the seconds the key took."""
    from repro_torch.core.formats import get_format
    rows = []
    for key in keys:
        batch, m, n, k, fmt_name, spec, backend = key
        report: list = []
        t0 = time.perf_counter()
        plan = dispatch.plan_gemm(m, n, k, fmt=get_format(fmt_name), spec=spec, batch=batch,
                                  backend=backend, autotune=True, report=report)
        seconds = time.perf_counter() - t0
        if not report:
            raise RuntimeError(f"plan key {key} was not measured (cached {plan.source})")
        pick = report[0]
        win = next(r for r in report if tuple(dataclasses.astuple(r["launch"])) == plan.launch)
        row = {"key": (batch, m, n, k), "pick_ms": pick["seconds"] * 1e3,
               "pick": pick["launch"], "win_ms": win["seconds"] * 1e3, "win": win["launch"],
               "rank": win["rank"], "seconds": seconds}
        rows.append(row)
        log(f"  (batch {batch}, m {m}, n {n}, k {k}): model pick {row['pick_ms']:.4f} ms "
            f"{_lay(pick['launch'])}; winner {row['win_ms']:.4f} ms {_lay(win['launch'])} "
            f"(cost rank {win['rank']}, {row['win_ms'] / row['pick_ms']:.4f}x); "
            f"{seconds:.2f} s")
    return rows


def _lay(lay) -> str:
    return "(" + ",".join(f"{f}={getattr(lay, f)}" for f in LAUNCH_FIELDS) + ")"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refresh", action="store_true",
                    help="measure the zoo on the card and save it")
    ap.add_argument("--out", default=None,
                    help=f"where to save (default {zoo_path(backend='cuda')})")
    args = ap.parse_args(argv)
    if not args.refresh:
        ap.print_help()
        return 2
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init
    dev = resolve_device("cuda")
    cfg = get_config(SERVE_ARCH)
    params = init(cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    keys = serve_keys(cfg, params, dev)
    print(f"[schedules] {len(keys)} plan keys from a {SERVE_ARCH} serve and continuous "
          f"engine under fdp91_kernel ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    rows = autotune_keys(keys)
    faster = sum(r["rank"] != 0 for r in rows)
    print(f"[schedules] autotuned {len(rows)} keys in {time.perf_counter() - t0:.2f} s: "
          f"{faster} winners are not the model pick")
    meta = {**card_meta(dev), "torch": torch.__version__, "cuda": torch.version.cuda,
            "served": f"{SERVE_ARCH} full width, fdp91_kernel: serve batch {SERVE_BATCH} "
                      f"prompt {SERVE_PROMPT} gen {SERVE_GEN}; continuous engine "
                      f"{ENGINE_SLOTS} slots max_len {ENGINE_MAX_LEN}"}
    zoo = ScheduleZoo.from_cache("cuda", meta=meta)
    out = args.out or zoo_path(backend="cuda")
    zoo.save(out)
    print(f"[schedules] {len(zoo.entries)} schedules -> {out}; meta {json.dumps(meta)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
