"""The port's dispatch layer against ``repro.core.dispatch``: site parsing,
pattern scoring and policy lookup agree; ``gemm``/``grouped_qk``/
``grouped_av`` are bit-equal in ``simulate`` and ``pallas`` mode and agree
within f32 reordering error in native mode."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402

torch.set_num_threads(1)

# TEMPORARY workaround for a fault of the JAX tests, not a need of this
# file (ROADMAP section 3, "The JAX suite depends on the order of its
# files"): importing repro.launch.dryrun inside tests/test_sharding.py
# appends 512 host devices to XLA_FLAGS, and a pytest worker whose JAX
# backend starts after that runs its later files on 512 devices, which the
# single-device mesh tests reject. Starting the backend while the suite is
# collected fixes one device count per worker. Remove this line when the
# JAX tests stop leaking the flag.
jax.devices()

SITES = ["attn_qk", "attn_qk@bwd.dA", "attn_qk@bwd.dB", "attn_av", "mlp_in",
         "mlp_in@bwd.dB", "lm_head", "attn_q", "generic@bwd"]
PATTERNS = ["attn_qk", "attn_*", "*", "attn_qk@bwd", "attn_qk@bwd.dA", "*@bwd",
            "attn_*@bwd.dB", "mlp_*@*", "lm_head@fwd", "nomatch", "*@bwd.dB"]


@pytest.mark.parametrize("site", SITES)
def test_site_parse_and_pattern_scores_match(site):
    js, ts = JD.GemmSite.parse(site), TD.GemmSite.parse(site)
    assert (js.name, js.phase, js.operand, js.key) == (ts.name, ts.phase, ts.operand, ts.key)
    for pat in PATTERNS:
        assert JD._parse_pattern(pat) == TD._parse_pattern(pat)
        assert JD._match_score(pat, js) == TD._match_score(pat, ts), (pat, site)


def test_policy_lookup_matches():
    def build(D, fmts, acc):
        spec = acc.AccumulatorSpec(9, 6, -20)
        pol = D.NumericsPolicy(D.GemmConfig(fmts.BF16, None, "native"))
        for i, pat in enumerate(PATTERNS):
            mode = ("native", "simulate", "pallas")[i % 3]
            pol = pol.with_override(pat, D.GemmConfig(
                fmts.FP32, None if mode == "native" else spec, mode))
        return pol

    jp, tp = build(JD, jfmt, jacc), build(TD, tfmt, tacc)
    for site in SITES:
        assert jp.lookup(site).tag() == tp.lookup(site).tag(), site
    assert TD.widen_config(tp.lookup("attn_qk")).tag() == JD.widen_config(jp.lookup("attn_qk")).tag()


def test_use_policy_is_per_thread_and_restores():
    assert TD.current_policy() is TD.MXU_BF16
    seen = []
    with TD.use_policy(TD.FDP91):
        t = threading.Thread(target=lambda: seen.append(TD.current_policy()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with pytest.raises(RuntimeError):
            with TD.use_policy(TD.MXU_FP32):
                raise RuntimeError
        assert TD.current_policy() is TD.FDP91
    assert seen == [TD.MXU_BF16]
    assert TD.current_policy() is TD.MXU_BF16


def _pair(mode, fmt_name="ieee_fp32"):
    js = jacc.AccumulatorSpec.paper_91bit()
    ts = tacc.AccumulatorSpec.paper_91bit()
    jf, tf = jfmt.get_format(fmt_name), tfmt.get_format(fmt_name)
    if mode == "native":
        js = ts = None
    return (JD.NumericsPolicy(JD.GemmConfig(jf, js, mode)),
            TD.NumericsPolicy(TD.GemmConfig(tf, ts, mode)))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 2).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("mode", ["simulate", "pallas"])
@pytest.mark.parametrize("fmt_name", ["ieee_fp32", "bfloat16"])
def test_fdp_modes_bit_equal(mode, fmt_name):
    jp, tp = _pair(mode, fmt_name)
    a, b, q, k, p, v = _inputs(1, (2, 3, 24), (24, 5), (1, 2, 2, 3, 8), (1, 2, 5, 8),
                               (1, 2, 2, 3, 5), (1, 2, 5, 8))
    T = torch.from_numpy
    with JD.use_policy(jp):
        jg = np.asarray(JD.gemm(jnp.asarray(a), jnp.asarray(b), site="t"))
        jqk = np.asarray(JD.grouped_qk(jnp.asarray(q), jnp.asarray(k)))
        jav = np.asarray(JD.grouped_av(jnp.asarray(p), jnp.asarray(v)))
    with TD.use_policy(tp):
        tg = TD.gemm(T(a), T(b), site="t").numpy()
        tqk = TD.grouped_qk(T(q), T(k)).numpy()
        tav = TD.grouped_av(T(p), T(v)).numpy()
    for want, got in ((jg, tg), (jqk, tqk), (jav, tav)):
        assert want.shape == got.shape
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def _reorder_bound(a, b):
    """|error| bound of an f32 dot product summed in any order:
    K * 2^-24 * (|a| @ |b|)."""
    return a.shape[-1] * 2.0 ** -24 * (np.abs(a).astype(np.float64) @ np.abs(b))


def test_native_fp32_within_reordering_error():
    jp, tp = _pair("native")
    a, b, q, k = _inputs(2, (2, 3, 40), (40, 5), (1, 2, 2, 3, 8), (1, 2, 5, 8))
    T = torch.from_numpy
    with JD.use_policy(jp):
        jg = np.asarray(JD.gemm(jnp.asarray(a), jnp.asarray(b), site="t"))
        jqk = np.asarray(JD.grouped_qk(jnp.asarray(q), jnp.asarray(k)))
    with TD.use_policy(tp):
        tg = TD.gemm(T(a), T(b), site="t")
        tqk = TD.grouped_qk(T(q), T(k))
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-6, atol=_reorder_bound(a, b).max())
    qk_bound = _reorder_bound(q.reshape(1, 2, 6, 8), np.swapaxes(k, -1, -2)).max()
    np.testing.assert_allclose(tqk.numpy(), jqk, rtol=1e-6, atol=qk_bound)


def test_native_bf16_returns_f32_of_bf16_operands():
    a, b = _inputs(3, (4, 16), (16, 3))
    with TD.use_policy(TD.MXU_BF16):
        got = TD.gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    want = (torch.from_numpy(a).bfloat16().double() @ torch.from_numpy(b).bfloat16().double())
    torch.testing.assert_close(got, want.float(), rtol=1e-6, atol=1e-6)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_site_counts_and_plan_cache():
    _, tp = _pair("pallas")
    a, b = _inputs(4, (2, 3, 24), (24, 5))
    TD.reset_sites_seen()
    TD.clear_plan_cache()
    launches = tk.fdp_gemm.launches
    with TD.use_policy(tp):
        for _ in range(3):
            TD.gemm(torch.from_numpy(a), torch.from_numpy(b), site="mlp_in")
        TD.gemm(torch.from_numpy(a[0]), torch.from_numpy(b), site="lm_head")
    assert TD.sites_seen() == {"mlp_in", "lm_head"}
    assert TD.site_calls() == {"mlp_in": 3, "lm_head": 1}
    # the kernel's tile is fixed: dispatch resolves no plan per call
    assert TD.plan_cache_stats() == TD.PlanCacheStats(0, 0, 0, 0, 0)
    assert tk.fdp_gemm.launches == launches        # CPU tensors: no launch
    for _ in range(2):
        plan = TD.plan_gemm(3, 5, 24, fmt=tfmt.FP32,
                            spec=tacc.AccumulatorSpec.paper_91bit(), batch=2, backend="cpu")
    assert TD.plan_cache_stats() == TD.PlanCacheStats(1, 1, 1, 0, 0)
    assert plan.tile == (8, 8, 24) and plan.fit(3, 5, 20000).bk == 24
    assert TD.GemmPlan(8, 8, 1 << 20).fit(8, 8, 1 << 20).bk == TD.SAFE_CHUNK
    TD.reset_sites_seen()
