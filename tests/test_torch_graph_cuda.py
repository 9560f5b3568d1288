"""The continuous batching engine's CUDA graph on the card (skips without
one): the graph engine's tokens equal the eager engine's, bit for bit,
under the 91-bit kernel policy, for a dense and an MoE model; one capture
per engine; a step's launches equal its FDP dispatches at capture, where the
wrappers count them as captured, and the replays move no wrapper's count
(``launches()`` is derived); the policy binds at capture;
``reset_cache`` serves again without capturing; a capture with a trace hook
installed raises.

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
