"""The continuous batching engine's CUDA graph on the card (skips without
one): the graph engine's tokens equal the eager engine's, bit for bit,
under the 91-bit kernel policy, for a dense and an MoE model; one capture
per engine; a step's launches equal its FDP dispatches at capture, where the
wrappers count them as captured, and the replays move no wrapper's count
(``launches()`` is derived); the policy binds at capture;
``reset_cache`` serves again without capturing; a capture with a trace hook
installed raises, unless it is the numerics monitor, whose reductions are
captured with the step: a monitored graph engine or score engine captures
once and its snapshot equals its eager twin's, two plans' engines leave the
last replayed call's capacity, and the monitor's device exponents agree
with the host's at the edge values. The serving tier on the card: the
score engine on one graph equals its eager twin, and a pool of graph
engines frees an evicted engine and captures it anew.

This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_graph_cuda.py
"""

import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402
from repro_torch.launch.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.launch.serve import FDP91_KERNEL  # noqa: E402
from repro_torch.models import init  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures a CUDA graph")


def _requests(vocab):
    g = torch.Generator().manual_seed(1)
    return [Request(uid=i, prompt=torch.randint(0, vocab, (n,), generator=g).tolist(),
                    max_new=m) for i, (n, m) in enumerate(((4, 3), (2, 5), (5, 2), (3, 4),
                                                           (1, 3)))]


def _serve(eng, vocab):
    reqs = _requests(vocab)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_graph_tokens_equal_eager_tokens(arch):
    _card()
    cfg = get_config(arch).reduced(n_kv_heads=2)
    params = init(cfg, 0, device="cuda")
    eager = ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=FDP91_KERNEL,
                              graph=False)
    want = _serve(eager, cfg.vocab_size)
    captured = {n: w.captured for n, w in tk.KERNELS.items()}
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=FDP91_KERNEL)
    assert eng.graphed and eng.capture_count == 1
    assert {n: w.captured - captured[n] for n, w in tk.KERNELS.items()
            if w.captured != captured[n]} == eng.step_launches
    kernels = {"fdp_gemm"} | ({"fdp_ragged_gemm"} if cfg.n_experts else set())
    assert set(eng.step_launches) == kernels
    ragged = {"moe_in", "moe_gate", "moe_out"}
    assert eng.step_launches.get("fdp_ragged_gemm", 0) == \
        sum(n for s, n in eng.step_dispatches.items() if s in ragged)
    assert eng.step_launches["fdp_gemm"] == \
        sum(n for s, n in eng.step_dispatches.items() if s not in ragged)
    before = {n: (w.launches, w.captured) for n, w in tk.KERNELS.items()}
    with TD.use_policy(TD.MXU_FP32):           # the policy bound at capture wins
        got = _serve(eng, cfg.vocab_size)
    assert got == want
    assert eng.capture_count == 1 and eng.replays > 0
    assert {n: (w.launches, w.captured) for n, w in tk.KERNELS.items()} == before
    assert eng.launches() == {n: k * eng.replays for n, k in eng.step_launches.items()}
    eng.reset_cache()
    assert _serve(eng, cfg.vocab_size) == want and eng.capture_count == 1


@pytest.mark.cuda
def test_capture_with_a_trace_hook_raises():
    _card()
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, 0, device="cuda")
    remove = TD.add_trace_hook(lambda *a: None)
    try:
        with pytest.raises(RuntimeError, match="trace hook"):
            ContinuousBatcher(cfg, params, n_slots=1, max_len=8, warmup=FDP91_KERNEL)
    finally:
        remove()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fdp91_kernel", "fdp91_simulate"])
def test_score_engine_graph_equals_eager(policy):
    """The score engine's padded forward, log-softmax, gather and masked sum
    on one CUDA graph equal its eager twin's, under the kernel policy and
    under ``simulate`` (whose dense path reads nothing back to the host)."""
    from repro_torch.serving import Bucket, ScoreEngine
    _card()
    pol = {"fdp91_kernel": FDP91_KERNEL, "fdp91_simulate": TD.FDP91}[policy]
    cfg = get_config("qwen3-0.6b").reduced(n_kv_heads=2)
    params = init(cfg, 0, device="cuda")
    bucket = Bucket(max_len=12, n_slots=2)
    prompts = [r.prompt for r in _requests(cfg.vocab_size)[:2]]
    eager = ScoreEngine(cfg, params, bucket, pol, graph=False).score_batch(prompts)
    eng = ScoreEngine(cfg, params, bucket, pol)
    assert eng.capture_count == 1
    fdp = sum(eng.step_dispatches.values())
    assert eng.step_launches == ({"fdp_gemm": fdp} if policy == "fdp91_kernel" else {})
    assert eng.score_batch(prompts) == eager
    assert eng.score_batch(prompts[::-1]) == eager[::-1] and eng.capture_count == 1


@pytest.mark.cuda
def test_pool_graph_engines_capture_once_and_free_on_eviction():
    """Routed through a pool of graph engines, tokens equal eager engines';
    an evicted engine is freed (its graph, private pool and KV cache), and
    serving its key again captures anew."""
    import gc
    import weakref

    from repro_torch.serving import BucketedEnginePool, RoutedPlan
    _card()
    cfg = get_config("qwen3-0.6b").reduced(n_kv_heads=2)
    params = init(cfg, 0, device="cuda")
    plans = [RoutedPlan(name=n, loader=lambda p=p: p)
             for n, p in (("kernel", FDP91_KERNEL), ("fp32", TD.MXU_FP32))]
    pool = BucketedEnginePool(cfg, params, "2x40", max_live=1)
    b = pool.buckets[0]
    first = pool.get(plans[0], b, "generate")
    assert first.capture_count == 1 and first.batcher.graphed
    ref = weakref.ref(first)
    got = _serve(first.batcher, cfg.vocab_size)
    del first
    second = pool.get(plans[1], b, "generate")            # evicts the idle first
    gc.collect()
    assert ref() is None and pool.stats()["evictions"] == 1
    del second
    again = pool.get(plans[0], b, "generate")
    assert again.capture_count == 1 and pool.stats()["compiles"] == 3
    assert _serve(again.batcher, cfg.vocab_size) == got
    eager = ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=FDP91_KERNEL,
                              graph=False)
    assert _serve(eager, cfg.vocab_size) == got


@pytest.mark.cuda
def test_monitor_on_the_card_reads_nonfinite_outputs_from_their_max():
    """On CUDA tensors the monitor's |out| max carries a NaN or an infinity
    through (its all-finite flag), and the hook reads nothing back until
    the fold."""
    from repro_torch.obs.monitor import NumericsMonitor
    from repro_torch.obs.registry import Registry
    _card()
    env = {"sites": {s: {"a_exp": [-8, 2], "b_exp": [-8, 2], "msb": 127, "lsb": None}
                     for s in ("nan", "inf", "ok")}}
    mon = NumericsMonitor(env, registry=Registry())
    a, b = torch.ones((4, 8), device="cuda"), torch.ones((8, 4), device="cuda")
    out = a @ b
    for site, bad in (("nan", float("nan")), ("inf", -float("inf")), ("ok", None)):
        o = out.clone()
        if bad is not None:
            o[1, 2] = bad
        mon.hook(site, TD.MXU_FP32.default, a, b, o)
    assert mon.folds == 0
    st = mon.statuses()
    assert mon.folds == 1
    assert {s: st[s]["live"]["nonfinite_events"] for s in ("nan", "inf", "ok")} == \
        {"nan": 1, "inf": 1, "ok": 0}
    assert st["ok"]["status"] == "inside" and st["nan"]["status"] == "violated"


@pytest.mark.cuda
def test_simulate_moe_engine_refuses_capture():
    """A ``simulate`` MoE step is captured: under capture
    ``core.fdp.fdp_ragged_gemm`` reads no group size on the host (every
    group over all rows, selected on the device), so the engine neither
    refuses the capture nor falls back to eager steps, and its graph's
    tokens equal its eager twin's."""
    _card()
    cfg = get_config("dbrx-132b").reduced(n_kv_heads=2)
    params = init(cfg, 0, device="cuda")
    eager = ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=TD.FDP91,
                              graph=False)
    want = _serve(eager, cfg.vocab_size)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=TD.FDP91)
    assert eng.graphed and eng.capture_count == 1 and not eng.step_launches
    assert _serve(eng, cfg.vocab_size) == want and eng.replays > 0
    torch.cuda.synchronize()


PLAN = os.path.join(os.path.dirname(__file__), "..", "examples", "plans", "paper_mlp.json")


@pytest.mark.cuda
def test_monitored_graph_engines_equal_their_eager_twins():
    """Under the numerics monitor a ``ContinuousBatcher`` and a
    ``ScoreEngine`` capture once, launch what an unmonitored engine does,
    read nothing back until a reader asks, give their eager twins' tokens
    and scores, and leave the snapshot their eager twins leave under a
    second monitor; the monitor counts each site's dispatches a step times
    the replays."""
    from repro_torch.numerics import load_plan
    from repro_torch.obs.monitor import monitoring
    from repro_torch.obs.registry import Registry
    from repro_torch.serving import Bucket, ScoreEngine
    _card()
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, 0, device="cuda")
    plan = load_plan(PLAN)
    bucket = Bucket(max_len=12, n_slots=2)
    prompts = [r.prompt for r in _requests(cfg.vocab_size)[:2]]
    bare = ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=FDP91_KERNEL)

    def run(graph):
        with monitoring(plan, registry=Registry()) as mon:
            eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=FDP91_KERNEL,
                                    graph=graph)
            score = ScoreEngine(cfg, params, bucket, FDP91_KERNEL, graph=graph)
            out = (_serve(eng, cfg.vocab_size), score.score_batch(prompts),
                   score.score_batch(prompts[::-1]))
            folds = mon.folds
        return mon, eng, score, out, folds

    gmon, geng, gscore, gout, gfolds = run(None)
    assert gfolds == 0 and gmon.folds == 1          # the copy at uninstall
    assert geng.capture_count == 1 and gscore.capture_count == 1
    assert geng.step_launches == bare.step_launches
    assert gscore.step_launches == {"fdp_gemm": sum(gscore.step_dispatches.values())}
    emon, eeng, escore, eout, _ = run(False)
    assert eeng.capture_count == 0 and gout == eout
    assert json.dumps(gmon.snapshot(), sort_keys=True) == \
        json.dumps(emon.snapshot(), sort_keys=True)
    calls = gmon.registry.counter("repro_monitor_calls_total", "", ("site",))
    for site in set(geng.step_dispatches) | set(gscore.step_dispatches):
        assert calls.value(site=site) == geng.step_dispatches.get(site, 0) * geng.replays \
            + gscore.step_dispatches.get(site, 0) * 2
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_capture_under_a_calibration_hook_raises():
    """The calibration slot is not capturable: with the monitor installed
    too, a capture raises."""
    from repro_torch.numerics.trace import calibrate
    from repro_torch.obs.monitor import NumericsMonitor
    from repro_torch.obs.registry import Registry
    _card()
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, 0, device="cuda")
    with NumericsMonitor(None, registry=Registry()), calibrate():
        with pytest.raises(RuntimeError, match="trace hook"):
            ContinuousBatcher(cfg, params, n_slots=1, max_len=8, warmup=FDP91_KERNEL)


@pytest.mark.cuda
def test_two_plans_engines_leave_the_last_replayed_capacity():
    """One site served by two graph engines of different plans, in turns:
    ``msb_capacity`` is the last replayed call's, as an eager pair of
    engines in the same order leaves it under a second monitor."""
    from repro_torch.core.accumulator import AccumulatorSpec
    from repro_torch.core.formats import FP32
    from repro_torch.obs.monitor import NumericsMonitor
    from repro_torch.obs.registry import Registry
    _card()
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, 0, device="cuda")
    low = TD.NumericsPolicy(TD.GemmConfig(FP32, AccumulatorSpec(9, 6, -20), "simulate"),
                            name="low")

    def run(graph):
        mon = NumericsMonitor(None, registry=Registry())
        caps = []
        with mon:
            engines = [ContinuousBatcher(cfg, params, n_slots=2, max_len=40, warmup=pol,
                                         graph=graph) for pol in (FDP91_KERNEL, low)]
            for i in (0, 1, 0):
                _serve(engines[i], cfg.vocab_size)
                engines[i].reset_cache()
                caps.append(mon.status("mlp_in")["live"]["msb_capacity"])
        return mon, caps, engines

    gmon, gcaps, engines = run(None)
    assert [e.capture_count for e in engines] == [1, 1]
    emon, ecaps, _ = run(False)
    assert gcaps == ecaps == [FDP91_KERNEL.lookup("mlp_in").acc.msb, 6,
                              FDP91_KERNEL.lookup("mlp_in").acc.msb]
    assert json.dumps(gmon.snapshot(), sort_keys=True) == \
        json.dumps(emon.snapshot(), sort_keys=True)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_device_exponents_agree_with_the_host_at_edge_values(device):
    """The monitor's device ``floor(log2 x)`` of float32 values (``torch.frexp``
    after widening to float64) against the host's ``math.frexp`` of the same
    value widened to double: 0, subnormals, the normal range's ends, inf,
    NaN and negatives (where the host's is None)."""
    from repro_torch.obs.monitor import _floor_log2, _floor_log2_t
    if device == "cuda":
        _card()
    tiny = torch.finfo(torch.float32).tiny
    vals = [0.0, -0.0, 2.0 ** -149, 3 * 2.0 ** -149, 2.0 ** -127, tiny * (1 - 2.0 ** -23),
            tiny, 0.75, 1.0, 1.5, 2.0 ** 100, torch.finfo(torch.float32).max, math.inf,
            -math.inf, math.nan, -2.0, -(2.0 ** -149)]
    x = torch.tensor(vals, dtype=torch.float32)
    exp, valid = _floor_log2_t(x.to(device))
    got = [int(e) if ok else None for e, ok in zip(exp.tolist(), valid.tolist())]
    assert got == [_floor_log2(v) for v in x.tolist()]
    assert got[2] == -149 and got[5] == -127 and got[6] == -126 and got[11] == 127
