"""The serving tier of the port (``repro_torch.serving``: engine pool,
frontend, CLI) on the CPU, where every engine runs eager steps (a CUDA graph
needs the card), held against ``repro.serving``.

One mixed trace on reduced paper-mlp — chat, solve (the derived FDP91
variant, ``simulate``), repro (the pinned bf16 91-bit variant), a stream, a
score, a request no plan satisfies and one no bucket fits — goes through the
JAX ``RoutedFrontend`` and the port's on the same weights (carried with
``params_from_numpy``) and prompts (numpy, seeded): the completions agree in
plan, bucket, tokens, steps, prefill and decode counts, stream and the
rejections' types; the score within a relative 1e-5 (native fp32 forwards
sum in another order); the pool's stats (less the process-global plan
cache), ``metrics()`` (less wall seconds; modeled energy within a relative
1e-9) and the per-class stats (less tok/s) are equal.

The reference's end-to-end cases (``tests/test_routed_serving.py``) run
against the port: routed tokens bit-identical to dedicated engines, LRU hits
and evictions, score against ``forward``, rejections as futures, the closed
sum, KV exhaustion and recycling. ``launch.serve --engine routed`` and
``python -m repro_torch.serving`` with a metrics dump, an injected violation
and a Chrome trace run on the CPU.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro import serving as JS  # noqa: E402
from repro_torch import serving as TSV  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.dispatch import use_policy  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.models import forward, init, params_from_numpy  # noqa: E402
from repro_torch.serving import (AdmissionError, Bucket, BucketedEnginePool,  # noqa: E402
                                 PlanRouter, RoutedFrontend, RoutingError, ScoreEngine,
                                 ServeRequest)
from repro_torch.serving.__main__ import main as serving_main  # noqa: E402

torch.set_num_threads(1)

PLANS_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "plans")
SCORE_RTOL = 1e-5

# uid -> (workload, method, prompt length, max_new, extra)
TRACE = {
    0: ("chat", "generate", 4, 5, {}),
    1: ("solve", "generate", 3, 4, {}),
    2: ("repro", "generate", 4, 4, {}),
    3: ("chat", "stream", 3, 5, {}),
    4: ("chat", "score", 13, 0, {}),
    5: ("chat", "generate", 8, 5, {}),
    6: ("chat", "generate", 2, 5, {}),
    7: ("chat", "generate", 3, 4, {"min_bits": 99.0}),     # no plan satisfies
    8: ("chat", "generate", 14, 5, {}),                     # no bucket fits
}
BUCKETS = "2x12,4x16"


def _trace(S, vocab):
    rng = np.random.default_rng(11)
    reqs, streams = [], {}
    for uid, (wl, method, plen, max_new, extra) in TRACE.items():
        req = S.ServeRequest(uid=uid, prompt=rng.integers(0, vocab, plen).tolist(),
                             max_new=max_new, workload=wl, method=method, **extra)
        if method == "stream":
            streams[uid] = []
            req.on_token = streams[uid].append
        reqs.append(req)
    return reqs, streams


def _serve(S, cfg, params):
    router = S.PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    pool = S.BucketedEnginePool(cfg, params, BUCKETS, max_live=4)
    front = S.RoutedFrontend(pool, router, max_live_batches=2)
    energy0 = front._m_energy.total()
    reqs, streams = _trace(S, cfg.vocab_size)
    comps = [front.submit(r) for r in reqs]
    front.run()
    metrics = front.metrics()
    metrics["energy_joules"] -= energy0        # the registry is process-wide
    return {"comps": comps, "streams": streams, "pool": pool.stats(), "metrics": metrics,
            "stats": front.stats(), "engines": pool.live()}


@pytest.fixture(scope="module")
def mixed():
    jc, tc = jget("paper-mlp").reduced(), tget("paper-mlp").reduced()
    jp = JT.init(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return _serve(JS, jc, jp), _serve(TSV, tc, tp), (tc, tp)


def _completion(c):
    return {"uid": c.request.uid, "ok": c.ok, "plan": c.plan, "bucket": c.bucket,
            "tokens": c.tokens, "steps": c.steps, "prefill": c.prefill_tokens,
            "decode": c.decode_tokens, "error": type(c.error).__name__ if c.error else None}


def test_mixed_trace_completions_equal_reference(mixed):
    j, t, _ = mixed
    assert [_completion(c) for c in t["comps"]] == [_completion(c) for c in j["comps"]]
    assert t["streams"] == j["streams"] and t["streams"][3] == t["comps"][3].tokens
    by_uid = {c.request.uid: c for c in t["comps"]}
    assert isinstance(by_uid[7].error, RoutingError)
    assert isinstance(by_uid[8].error, AdmissionError)
    assert {by_uid[u].plan for u in (0, 1, 2)} == \
        {"paper_mlp", "paper_mlp/fdp91", "paper_mlp/repro"}
    assert {c.bucket for c in t["comps"] if c.ok} == {"2x12", "4x16"}
    assert all(len(by_uid[u].tokens) == TRACE[u][3] for u in (0, 1, 2, 3, 5, 6))


def test_mixed_trace_score_equals_reference(mixed):
    j, t, _ = mixed
    js, ts = j["comps"][4].result(), t["comps"][4].result()
    assert np.isfinite(ts) and ts < 0
    assert ts == pytest.approx(js, rel=SCORE_RTOL)


def test_mixed_trace_accounting_equals_reference(mixed):
    j, t, _ = mixed
    drop = lambda d, *ks: {k: v for k, v in d.items() if k not in ks}   # noqa: E731
    assert drop(t["pool"], "plans") == drop(j["pool"], "plans")
    assert t["pool"]["evictions"] >= 1        # six engines through a cap of four
    tm, jm = t["metrics"], j["metrics"]
    assert drop(tm, "wall_seconds", "energy_joules") == drop(jm, "wall_seconds", "energy_joules")
    assert tm["energy_joules"] > 0
    assert tm["energy_joules"] == pytest.approx(jm["energy_joules"], rel=1e-9)
    assert tm["submitted"] == tm["routed"] + tm["parked"] + tm["rejected"]
    tc = {wl: drop(st, "tokens_per_s") for wl, st in t["stats"]["classes"].items()}
    jc = {wl: drop(st, "tokens_per_s") for wl, st in j["stats"]["classes"].items()}
    assert tc == jc


def test_mixed_trace_engines_run_eager_on_the_cpu(mixed):
    _, t, _ = mixed
    assert t["engines"] and all(e.capture_count == 0 for e in t["engines"].values())


# ---------------------------------------------------------------------------
# the reference's end-to-end cases against the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mlp():
    cfg = tget("paper-mlp").reduced()
    return cfg, init(cfg, seed=0, device="cpu")


def test_pool_lru_and_hits(mlp):
    cfg, params = mlp
    r = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    pool = BucketedEnginePool(cfg, params, "2x16", max_live=1)
    b = pool.buckets[0]
    e1 = pool.get(r.route("chat"), b, "generate")
    assert pool.get(r.route("chat"), b, "generate") is e1    # cache hit
    pool.get(r.route("solve"), b, "generate")                # evicts idle e1
    st = pool.stats()
    assert st == {**st, "compiles": 2, "hits": 1, "evictions": 1, "resident": 1}
    assert st["bucket_hits"] == {"2x16": 3} and st["bucket_hit_rate"] == 1 / 3
    e2 = pool.get(r.route("chat"), b, "generate")            # built again
    assert e2 is not e1 and pool.stats()["compiles"] == 3


def test_routed_vs_dedicated_bit_identical(mlp):
    """Two workload classes served through the routed tier equal dedicated
    single-plan engines bit for bit; every engine ran eager steps."""
    cfg, params = mlp
    router = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    pool = BucketedEnginePool(cfg, params, "2x32", max_live=4)
    front = RoutedFrontend(pool, router, max_live_batches=2)
    prompts = [[5, 9, 2], [7, 1, 8, 3], [4, 4, 6], [9, 2, 2, 7]]
    classes = ["chat", "solve", "chat", "solve"]
    comps = [front.submit(ServeRequest(uid=i, prompt=p, max_new=5, workload=wl))
             for i, (p, wl) in enumerate(zip(prompts, classes))]
    front.run()
    assert all(c.ok for c in comps)
    by_class = {wl: [c for c in comps if c.request.workload == wl] for wl in ("chat", "solve")}
    assert {c.plan for c in by_class["chat"]} != {c.plan for c in by_class["solve"]}
    for wl, batch in by_class.items():
        ded = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                                warmup=router.route(wl).policy())
        refs = [Request(uid=c.request.uid, prompt=list(c.request.prompt), max_new=5)
                for c in batch]
        for rr in refs:
            ded.submit(rr)
        ded.run()
        for c, rr in zip(batch, refs):
            assert c.result() == rr.out and c.steps == rr.steps
        assert ded.capture_count == 0
    assert all(e.capture_count == 0 for e in pool.live().values())
    st = front.stats()
    assert st["classes"]["chat"]["completed"] == 2
    assert st["classes"]["solve"]["plans"] == {"paper_mlp/fdp91": 2}


def test_frontend_rejections_are_futures(mlp):
    cfg, params = mlp
    router = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    front = RoutedFrontend(BucketedEnginePool(cfg, params, "2x16"), router, max_queue=1)
    c1 = front.submit(ServeRequest(uid=0, prompt=[1, 2], max_new=4, min_bits=99.0))
    c2 = front.submit(ServeRequest(uid=1, prompt=list(range(14)), max_new=8))
    c3 = front.submit(ServeRequest(uid=2, prompt=[1, 2], max_new=4, method="train"))
    c4 = front.submit(ServeRequest(uid=3, prompt=[1, 2], max_new=2))      # queued
    c5 = front.submit(ServeRequest(uid=4, prompt=[3, 4], max_new=2))      # queue at cap
    assert c1.done and not c1.ok and isinstance(c1.error, RoutingError)
    for c in (c2, c3, c5):
        assert c.done and not c.ok and isinstance(c.error, AdmissionError)
    assert "backpressure cap" in str(c5.error)
    with pytest.raises(AdmissionError):
        c2.result()
    with pytest.raises(RuntimeError, match="still pending"):
        c4.result()
    front.run()
    assert c4.ok and len(c4.result()) == 2
    assert front.stats()["classes"]["chat"]["rejected"] == 4


def test_frontend_metrics_sum_invariant(mlp):
    cfg, params = mlp
    router = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    front = RoutedFrontend(BucketedEnginePool(cfg, params, "2x32"), router)
    comps = [front.submit(ServeRequest(uid=i, prompt=[3 + i, 7, 1], max_new=4))
             for i in range(3)]
    front.submit(ServeRequest(uid=9, prompt=[1, 2], max_new=4, min_bits=99.0))
    m = front.metrics()
    assert (m["submitted"], m["rejected"], m["parked"], m["completed"]) == (4, 1, 3, 0)
    assert m["submitted"] == m["routed"] + m["parked"] + m["rejected"]
    front.run()
    assert all(c.ok for c in comps)
    m = front.metrics()
    assert (m["submitted"], m["parked"], m["completed"], m["routed"]) == (4, 0, 3, 3)
    assert m["submitted"] == m["routed"] + m["parked"] + m["rejected"]
    assert m["wall_seconds"] > 0


def test_score_method_matches_forward(mlp):
    cfg, params = mlp
    plan = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp").route("solve")
    eng = ScoreEngine(cfg, params, Bucket(max_len=16, n_slots=2), plan.policy())
    prompt = [3, 11, 4, 7]
    (got,) = eng.score_batch([prompt])
    toks = torch.zeros((2, 16), dtype=torch.long)
    toks[0, :4] = torch.tensor(prompt)
    with use_policy(plan.policy()), torch.no_grad():
        logits = forward(params, cfg, {"tokens": toks})
    logp = torch.log_softmax(logits[:, :, :cfg.vocab_size], -1)
    want = float(sum(logp[0, j, prompt[j + 1]] for j in range(3)))
    assert got == pytest.approx(want, rel=SCORE_RTOL)
    assert eng.capture_count == 0
    with pytest.raises(ValueError, match="prompts > bucket"):
        eng.score_batch([prompt] * 3)


def test_exhaustion_parks_then_recycles(mlp):
    """One slot, a cache of 15 positions, three requests of 9: the second
    parks until the first drains, the drained engine's cursor is rewound,
    and every request completes untruncated with the same tokens."""
    cfg, params = mlp
    router = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    pool = BucketedEnginePool(cfg, params, "1x16")
    front = RoutedFrontend(pool, router)
    comps = [front.submit(ServeRequest(uid=i, prompt=[5, 9, 2, 8], max_new=5))
             for i in range(3)]
    assert front.metrics()["parked"] == 3
    front.run()
    assert all(c.ok and len(c.tokens) == 5 for c in comps)
    assert comps[0].tokens == comps[1].tokens == comps[2].tokens
    assert pool.stats()["compiles"] == 1


def test_stalled_frontend_raises(mlp):
    cfg, params = mlp
    router = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    front = RoutedFrontend(BucketedEnginePool(cfg, params, "2x16"), router,
                           max_live_batches=0)
    front.submit(ServeRequest(uid=0, prompt=[1, 2], max_new=2))
    with pytest.raises(RuntimeError, match="stalled"):
        front.run()


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------
def test_launch_serve_routed_on_the_cpu(capsys):
    TLS.main(["--arch", "paper-mlp", "--reduced", "--device", "cpu", "--engine", "routed",
              "--batch", "2", "--prompt-len", "4", "--gen", "3", "--workload", "chat"])
    out = capsys.readouterr().out
    assert "[serve:routed] chat: 2/2 ok via paper_mlp" in out
    assert "[serve:routed] pool: 1 compiles, buckets={'2x9': 1}" in out
    assert "engine=routed policy=routed device=cpu" in out
    with pytest.raises(SystemExit, match="use --workload"):
        TLS.main(["--engine", "routed", "--device", "cpu", "--policy", "fdp91_kernel"])


def test_launch_serve_monitor_builds_eager_engines(tmp_path, capsys):
    dump = tmp_path / "dump.json"
    TLS.main(["--arch", "paper-mlp", "--reduced", "--device", "cpu", "--engine",
              "continuous", "--batch", "2", "--prompt-len", "3", "--gen", "2", "--monitor",
              "--precision-plan", os.path.join(PLANS_DIR, "paper_mlp.json"),
              "--metrics-dump", str(dump)])
    out = capsys.readouterr().out
    assert "the continuous engine is captured with the monitor's reductions inside" in out
    assert "[serve] monitor: worst=inside" in out
    doc = json.loads(dump.read_text())
    assert doc["kind"] == "repro.obs.ServingMetricsDump" and doc["engine"] == "continuous"
    assert doc["monitor"]["worst_status"] == "inside"


def test_serving_cli_dump_violation_and_trace(tmp_path, capsys):
    dump, trace = tmp_path / "dump.json", tmp_path / "trace.json"
    serving_main(["--arch", "paper-mlp", "--reduced", "--device", "cpu", "--requests", "4",
                  "--max-new", "3", "--require-complete", "--metrics-dump", str(dump),
                  "--inject-violation", "attn_qk", "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "  plans: 0 preloaded from zoo; cache size=" in out    # no cpu zoo in the port
    assert "injected out-of-envelope dispatch at site 'attn_qk'" in out
    doc = json.loads(dump.read_text())
    assert doc["kind"] == "repro.obs.ServingMetricsDump"
    m = doc["serving"]
    assert m["submitted"] == m["routed"] + m["parked"] + m["rejected"] == m["completed"] == 4
    sites = doc["monitor"]["sites"]
    assert sites["attn_qk"]["status"] == "violated"
    assert all(i["status"] == "inside" for s, i in sites.items()
               if s != "attn_qk" and i["live"] is not None)
    events = json.loads(trace.read_text())["traceEvents"]
    assert {e["name"] for e in events} >= {"serving.run", "serving.request",
                                          "serving.route", "serving.aot_compile"}
