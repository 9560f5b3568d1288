"""The continuous batching engine's CUDA graph on the card (skips without
one): the graph engine's tokens equal the eager engine's, bit for bit,
under the 91-bit kernel policy, for a dense and an MoE model; one capture
per engine; a step's launches equal its FDP dispatches at capture, where the
wrappers count them as captured, and the replays move no wrapper's count
(``launches()`` is derived); the policy binds at capture;
``reset_cache`` serves again without capturing; a capture with a trace hook
installed raises. The serving tier on the card: the score engine on one
graph equals its eager twin, and a pool of graph engines frees an evicted
engine and captures it anew.

This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_graph_cuda.py
"""

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
