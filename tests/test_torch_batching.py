"""The continuous batching engine of the port (``repro_torch.launch.batching``)
on the CPU, where it runs eager steps (a CUDA graph needs the card).

Held against ``repro.launch.batching.ContinuousBatcher`` on the same weights
(carried across with ``params_from_numpy``) and the same requests (prompts
from numpy with a seed): every request's tokens, its ``on_token`` stream and
its counters, and the engine's step count, equal under native fp32 and under
the 91-bit FDP (JAX ``simulate`` FDP91 against the port's kernel policy,
whose wrappers run their plain versions on CPU tensors), for a dense and an
MoE model, with more requests than slots, mixed prompt lengths and an EOS
that fires. Also the reference's three scheduler tests (``test_serving.py``)
against the port's own simple serve, the cache wall, the engine's refusals,
and a decode step whose cursor is a device tensor.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.launch import batching as JB  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs.spans import recorder as jrecorder  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.launch import batching as TB  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import decode_step, init_cache, params_from_numpy  # noqa: E402
from repro_torch.obs.spans import recorder as trecorder  # noqa: E402

torch.set_num_threads(1)

# GQA (2 KV heads for 4 query heads) on the reduced attention models
OVERRIDES = {"qwen3-0.6b": dict(n_kv_heads=2), "dbrx-132b": dict(n_kv_heads=2)}
POLICIES = {"native_fp32": (JD.MXU_FP32, TD.MXU_FP32),
            "fdp91": (JD.FDP91, TS.FDP91_KERNEL)}


def _models(arch):
    over = OVERRIDES.get(arch, {})
    jc, tc = jget(arch).reduced(**over), tget(arch).reduced(**over)
    jp = JT.init(jc, jax.random.key(0))
    return jc, jp, tc, params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _models("qwen3-0.6b")


def _requests(make, vocab, seed=4):
    """Five requests of mixed prompt lengths (2-5 tokens, 3-4 generated)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid, n in enumerate((3, 5, 2, 4, 3)):
        stream = []
        reqs.append(make(uid=uid, prompt=rng.integers(0, vocab, n).tolist(),
                         max_new=3 + uid % 2, on_token=stream.append))
        reqs[-1].stream = stream
    return reqs


def _drive(B, cfg, params, pol, *, n_slots, max_len, eos_id=None, rec=None):
    reqs = _requests(B.Request, cfg.vocab_size)
    use = JD.use_policy if B is JB else TD.use_policy
    rec.clear()
    with use(pol):
        eng = B.ContinuousBatcher(cfg, params, n_slots=n_slots, max_len=max_len,
                                  eos_id=eos_id)
        for r in reqs:
            eng.submit(r)
        eng.run()
    runs = [e for e in rec.events() if e["name"] == "serving.batcher_run"]
    assert len(runs) == 1
    return reqs, runs[0]["args"]


def _record(reqs):
    return [(r.uid, r.out, r.done, r.steps, r.prefill_tokens, r.decode_tokens, r.stream)
            for r in reqs]


@pytest.mark.parametrize("arch,policy", [("qwen3-0.6b", "native_fp32"),
                                         ("qwen3-0.6b", "fdp91"),
                                         ("dbrx-132b", "native_fp32"),
                                         ("dbrx-132b", "fdp91")])
def test_engine_equals_reference(arch, policy):
    jc, jp, tc, tp = _models(arch)
    jpol, tpol = POLICIES[policy]
    kw = dict(n_slots=2, max_len=40)
    jreqs, jrun = _drive(JB, jc, jp, jpol, rec=jrecorder(), **kw)
    # an EOS that fires: the second token request 1 generates
    eos = jreqs[1].out[1]
    jreqs_e, jrun_e = _drive(JB, jc, jp, jpol, rec=jrecorder(), eos_id=eos, **kw)
    assert any(r.done and len(r.out) < r.max_new for r in jreqs_e)
    treqs, trun = _drive(TB, tc, tp, tpol, rec=trecorder(), **kw)
    treqs_e, trun_e = _drive(TB, tc, tp, tpol, rec=trecorder(), eos_id=eos, **kw)
    assert _record(treqs) == _record(jreqs)
    assert _record(treqs_e) == _record(jreqs_e)
    assert trun == jrun and trun_e == jrun_e        # n_slots, max_len, steps


def test_cache_exhausted_at_the_same_point(qwen):
    jc, jp, tc, tp = qwen
    out = {}
    for B, cfg, params, use, pol in ((JB, jc, jp, JD.use_policy, JD.MXU_FP32),
                                     (TB, tc, tp, TD.use_policy, TD.MXU_FP32)):
        reqs = [B.Request(uid=i, prompt=[2 + i, 7, 3], max_new=3) for i in range(3)]
        with use(pol):
            eng = B.ContinuousBatcher(cfg, params, n_slots=1, max_len=12)
            for r in reqs:
                eng.submit(r)
            with pytest.raises(B.CacheExhausted) as err:
                eng.run()
        out[B] = (str(err.value), [(r.out, r.done) for r in reqs], eng.cache_remaining())
    assert out[TB] == out[JB]
    assert "head needs 6 positions, cache_remaining()=1 of max_len=12" in out[TB][0]


def test_refusals(qwen):
    _, _, tc, tp = qwen
    eng = TB.ContinuousBatcher(tc, tp, n_slots=1, max_len=16)
    eng.submit(TB.Request(uid=0, prompt=[1, 2, 3], max_new=2))
    with TD.use_policy(TD.MXU_FP32):
        assert eng.step()
    with pytest.raises(RuntimeError, match="live slots"):
        eng.reset_cache()
    with pytest.raises(TypeError, match="not both"):
        TB.ContinuousBatcher(tc, tp, warmup=TD.MXU_FP32, policy=TD.MXU_FP32)
    with pytest.raises(ValueError, match="graph=True"):
        TB.ContinuousBatcher(tc, tp, graph=True)
    # the CPU default is eager steps: nothing captured, no replay
    assert eng.graphed is False and eng.capture_count == 0 and eng.launches() == {}


def test_reset_cache_reclaims_room(qwen):
    """A drained engine zeroes its cache in place and serves again from
    cursor 0 with the same tokens."""
    _, _, tc, tp = qwen
    eng = TB.ContinuousBatcher(tc, tp, n_slots=2, max_len=12, policy=TD.MXU_FP32)
    first = [TB.Request(uid=i, prompt=[5 + i, 9], max_new=4) for i in range(2)]
    for r in first:
        eng.submit(r)
    eng.run()
    assert eng.cache_remaining() == 6
    k = eng.cache["layers"]["k"]
    storage = k.data_ptr()
    eng.reset_cache()
    assert eng.cache_remaining() == 11 and int(eng.cache["len"]) == 0
    assert k.data_ptr() == storage and not k.any()
    again = [TB.Request(uid=i, prompt=[5 + i, 9], max_new=4) for i in range(2)]
    for r in again:
        eng.submit(r)
    eng.run()
    assert [r.out for r in again] == [r.out for r in first]


def test_tensor_cursor_step_equals_int_cursor(qwen):
    """decode_step with cache["len"] a 0-d tensor (and a start mask of
    zeros) gives the int-cursor step's logits and cache, bit for bit."""
    _, _, tc, tp = qwen
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, tc.vocab_size, (2, 5)))
    ci = init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
    ct = init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
    ct["len"] = torch.zeros((), dtype=torch.int64)
    ct["start"] = torch.zeros(2, dtype=torch.int64)
    with TD.use_policy(TS.FDP91_KERNEL):
        for t in range(toks.shape[1]):
            li, ci = decode_step(tp, tc, ci, toks[:, t:t + 1])
            lt, ct = decode_step(tp, tc, ct, toks[:, t:t + 1])
            assert torch.equal(li, lt)
    assert ci["len"] == int(ct["len"]) == 5
    for name in ("k", "v"):
        assert torch.equal(ci["layers"][name], ct["layers"][name])


# ---------------------------------------------------------------------------
# the reference's scheduler tests (tests/test_serving.py), on the port
# ---------------------------------------------------------------------------
def _ref_generate(cfg, params, prompt, n):
    """Reference: isolated whole-batch greedy decode."""
    with TD.use_policy(TD.MXU_FP32):
        toks = TS.serve(cfg, params, torch.tensor([prompt]), n, device="cpu")
    return toks[0].tolist()


def test_slot_reuse_isolated(qwen):
    """Two requests through ONE slot sequentially == each served alone."""
    _, _, cfg, params = qwen
    r1 = TB.Request(1, [5, 9, 2], max_new=5)
    r2 = TB.Request(2, [7, 1, 8, 3], max_new=5)
    with TD.use_policy(TD.MXU_FP32):
        eng = TB.ContinuousBatcher(cfg, params, n_slots=1, max_len=64)
        eng.submit(r1)
        eng.submit(r2)
        eng.run()
    assert r1.done and r2.done
    assert r1.out == _ref_generate(cfg, params, r1.prompt, 5)
    assert r2.out == _ref_generate(cfg, params, r2.prompt, 5)


def test_parallel_slots_match_reference(qwen):
    _, _, cfg, params = qwen
    reqs = [TB.Request(i, [3 + i, 11, 4 + i], max_new=4) for i in range(3)]
    with TD.use_policy(TD.MXU_FP32):
        eng = TB.ContinuousBatcher(cfg, params, n_slots=4, max_len=48)
        for r in reqs:
            eng.submit(r)
        eng.run()
    for r in reqs:
        assert r.done
        assert r.out == _ref_generate(cfg, params, r.prompt, 4)


def test_more_requests_than_slots(qwen):
    """Queue drains through limited slots; all complete."""
    _, _, cfg, params = qwen
    reqs = [TB.Request(i, [2 + i, 6], max_new=3) for i in range(5)]
    with TD.use_policy(TD.MXU_FP32):
        eng = TB.ContinuousBatcher(cfg, params, n_slots=2, max_len=64)
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 3 for r in reqs)


def test_serve_requests_under_a_plan_policy(qwen):
    """``serve_requests`` with ``warmup=<policy>`` (the policy binds the
    engine's steps) equals the reference's under the same policy."""
    jc, jp, tc, tp = qwen
    prompts = [[4, 8, 1], [9, 2], [6, 6, 6, 1]]
    want = JB.serve_requests(jc, jp, [JB.Request(i, p, max_new=3)
                                      for i, p in enumerate(prompts)],
                             n_slots=2, max_len=32, warmup=JD.MXU_FP32)
    got = TB.serve_requests(tc, tp, [TB.Request(i, p, max_new=3)
                                     for i, p in enumerate(prompts)],
                            n_slots=2, max_len=32, warmup=TD.MXU_FP32)
    assert [r.out for r in got] == [r.out for r in want]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_main_continuous_runs_on_cpu(capsys, arch):
    TS.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "3",
             "--gen", "2", "--device", "cpu", "--policy", "fdp91_kernel",
             "--engine", "continuous"])
    out = capsys.readouterr().out
    assert "engine=continuous policy=fdp91_kernel device=cpu" in out and "sample:" in out
