"""The workload zoo in the port against ``repro.workloads``, and what it
stands on: ``data.conditioned`` and the Fig. 2 dot baselines
(``fdp_dot64``, ``accumulator.to_float64``, ``fma_dot``, ``two_sum``,
``two_prod``, ``dd_dot``); the registry and the ``Validator`` protocol
(reports, ``eligible_site``, ``probed_sites``, the 91-bit-bwd reference
policy); the synthetic workloads (``solve``, ``repro``); ``quant_opt``; the
CLI; and the device-side gradient scoring. The model-bound workloads are in
``test_torch_workloads_models.py`` (paper-mlp) and
``test_torch_workloads_qwen.py`` (qwen3-0.6b), the validated search in
``test_torch_workloads_search.py``. Every port call runs on the CPU.

Tolerances, and why:
- Generators, the dot baselines and ``to_float64``: bit-equal. The
  generators are the same numpy code; the baselines are exact
  transformations (``fma_dot`` one rounding a step in both: XLA contracts
  the reference's ``s + x * y`` into an FMA, which the port emulates).
- ``solve`` and ``repro`` under ``simulate`` policies: scores, attribution
  and details bit-equal (the same numpy operands through bit-exact GEMMs).
  Under native fp32: within 1.2 bits, the bound of
  ``test_torch_numerics_search.py`` (summation order, ROADMAP section 3).
- ``quant_opt``: per-step bits within 1.0 (the losses of two f32 training
  runs whose elementwise ops differ by ulps; measured gaps are 0).
- Device-side gradient scoring against the numpy formula: correct bits
  within 1e-12 (``log2`` of two libraries), medians and the cosine within
  1e-12.

Modelled on ``tests/test_workloads.py``."""

import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.workloads as JW  # noqa: E402
import repro_torch.workloads as TW  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import accumulator as JA  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import fdp as JF  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.core import metrics as JM  # noqa: E402
from repro.core import qformat as JQ  # noqa: E402
from repro.data import conditioned as JC  # noqa: E402
from repro.numerics import load_plan as jload  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import accumulator as TA  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import fdp as TF  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core import metrics as TM  # noqa: E402
from repro_torch.core import qformat as TQ  # noqa: E402
from repro_torch.data import conditioned as TC  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.numerics import load_plan as tload  # noqa: E402

torch.set_num_threads(1)

TWG = importlib.import_module("repro_torch.workloads.gradients")
TWM = importlib.import_module("repro_torch.workloads.__main__")
BUDGET = 10.0
NATIVE_BITS_TOL = 1.2
QUANT_OPT_BITS_TOL = 1.0
SCORING_TOL = 1e-12
PAPER_PLAN = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "plans",
                          "paper_mlp.json")


def _cfgs(spec):
    """(fmt name, (ovf, msb, lsb) or None, mode) -> the two packages' GemmConfig."""
    fmt, acc, mode = spec
    j = JD.GemmConfig(jfmt.get_format(fmt), JA.AccumulatorSpec(*acc) if acc else None, mode)
    t = TD.GemmConfig(tfmt.get_format(fmt), TA.AccumulatorSpec(*acc) if acc else None, mode)
    return j, t


def _policies(default, overrides, aux=(), name="test"):
    """The same policy in both packages from plain specs."""
    jd, td = _cfgs(default)
    jo, to = [], []
    for pat, spec in overrides:
        j, t = _cfgs(spec)
        jo.append((pat, j))
        to.append((pat, t))
    jpol = JD.NumericsPolicy(jd, tuple(jo), name,
                             aux=tuple((k, JQ.parse_quant(q)) for k, q in aux))
    tpol = TD.NumericsPolicy(td, tuple(to), name,
                             aux=tuple((k, TQ.parse_quant(q)) for k, q in aux))
    return jpol, tpol


FP32_NATIVE = ("ieee_fp32", None, "native")
SIM91 = ("ieee_fp32", (30, 30, -30), "simulate")
NARROW = ("ieee_fp32", (4, 8, -16), "simulate")
BF16_SIM = ("bfloat16", (8, 13, -18), "simulate")


# ---------------------------------------------------------------------------
# data.conditioned and the Fig. 2 dot baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,cond,seed", [(6, 1e4, 0), (64, 1e8, 3), (257, 1e14, 17)])
def test_conditioned_generators_bit_equal(n, cond, seed):
    ja, jb, jex = JC.gen_dot(n, cond, seed)
    ta, tb, tex = TC.gen_dot(n, cond, seed)
    assert ja.dtype == ta.dtype == np.float32
    assert np.array_equal(ja, ta) and np.array_equal(jb, tb) and jex == tex
    jA, jx, jexact = JC.gen_linear_system(min(n, 24), cond, seed)
    tA, tx, texact = TC.gen_linear_system(min(n, 24), cond, seed)
    for j, t in ((jA, tA), (jx, tx), (jexact, texact)):
        assert j.dtype == t.dtype and np.array_equal(j, t)
    b32 = np.float32(jexact)
    assert np.array_equal(JC.residual_exact(jA, jx, b32), TC.residual_exact(tA, tx, b32))
    for j, t in zip(JC.ssh_surrogate_batch(n, cond, m=3, seed=seed),
                    TC.ssh_surrogate_batch(n, cond, m=3, seed=seed)):
        assert np.array_equal(j, t)


def _grid12(x):
    """The SSH benchmark's 12-fraction-bit grid (every product on the
    91-bit register's grid)."""
    return np.asarray(np.rint(x.astype(np.float64) * 4096.0) / 4096.0, np.float32)


@pytest.mark.parametrize("n,seed", [(64, 1), (512, 18)])
def test_dot_baselines_bit_equal(n, seed):
    a, b, _ = JC.gen_dot(n, 1e14, seed)
    spec_j, spec_t = JA.AccumulatorSpec.paper_91bit(), TA.AccumulatorSpec.paper_91bit()
    with jax.enable_x64(True):
        for x, y in ((a, b), (_grid12(a), _grid12(b))):
            j = float(JF.fdp_dot64(jnp.asarray(x), jnp.asarray(y), spec_j))
            t = TF.fdp_dot64(torch.from_numpy(x), torch.from_numpy(y), spec_t)
            assert t.dtype == torch.float64 and float(t) == j
            for jdt, tdt in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
                xa, ya = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
                tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
                assert float(TF.fma_dot(tx, ty, tdt)) == float(JF.fma_dot(xa, ya, jdt))
                assert float(TF.dd_dot(tx, ty, tdt)) == float(JF.dd_dot(xa, ya, jdt))
                for fn in ("two_sum", "two_prod"):
                    jo = getattr(JF, fn)(xa, ya)
                    to = getattr(TF, fn)(tx, ty)
                    for jv, tv in zip(jo, to):
                        assert np.array_equal(np.asarray(jv), tv.numpy()), fn
    # the 12-bit grid: FDP91 exact, at the 53-bit cap (the Fig. 2 claim)
    x, y = _grid12(a), _grid12(b)
    exact = float(TM.exact_dot_fraction(x, y))
    got = TF.fdp_dot64(torch.from_numpy(x), torch.from_numpy(y), spec_t)
    assert float(TM.correct_bits(got, exact)) == 53.0


def test_fma_dot_rounds_once_a_step():
    """Each step is x * y + s rounded once (an FMA), as XLA's contraction of
    the reference's scan body computes it; two roundings would differ."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    fused = unfused = 0
    for _ in range(20):
        a = rng.standard_normal(32)
        b = rng.standard_normal(32) * np.where(np.arange(32) % 3 == 0, -1e3, 1.0)
        want, two = 0.0, 0.0
        for x, y in zip(a.tolist(), b.tolist()):
            want = float(Fraction(want) + Fraction(x) * Fraction(y))
            two = two + x * y
        got = float(TF.fma_dot(torch.from_numpy(a), torch.from_numpy(b), torch.float64))
        assert got == want
        fused += got == want
        unfused += got == two
    assert unfused < fused


@pytest.mark.parametrize("spec", [(30, 30, -30, "trunc", "wrap"), (2, 40, -60, "rne", "wrap"),
                                  (4, 8, -16, "trunc", "saturate"), (60, 60, -60, "rne", "wrap")],
                         ids=str)
def test_to_float64_bit_equal(spec):
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((6, 40)) * 2.0 ** rng.integers(-12, 12, (6, 40))).astype(np.float32)
    b = (rng.standard_normal((40, 5)) * 2.0 ** rng.integers(-12, 12, (40, 5))).astype(np.float32)
    js, ts = JA.AccumulatorSpec(*spec), TA.AccumulatorSpec(*spec)
    limbs = TF.fdp_gemm_limbs(torch.from_numpy(a), torch.from_numpy(b), ts)
    np.testing.assert_array_equal(
        limbs.numpy(), np.asarray(JF.fdp_gemm_limbs(jnp.asarray(a), jnp.asarray(b), js)))
    with jax.enable_x64(True):
        want = np.asarray(JA.to_float64(js, jnp.asarray(limbs.numpy())))
    got = TA.to_float64(ts, limbs)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.any(got.numpy() != got.numpy().astype(np.float32))   # 53 bits, not 24


# ---------------------------------------------------------------------------
# registry and protocol
# ---------------------------------------------------------------------------
def test_registry_matches_the_reference():
    assert TW.available_workloads() == JW.available_workloads()
    assert TW.DEFAULT_VALIDATORS == JW.DEFAULT_VALIDATORS
    assert sorted(TW.__all__) == sorted(JW.__all__)
    assert (TW.PROBE_BATCH, TW.PROBE_SEQ, TW.PROBE_SEED, TW.SUMMARY_KEYS) == \
        (JW.PROBE_BATCH, JW.PROBE_SEQ, JW.PROBE_SEED, JW.SUMMARY_KEYS)
    for name in TW.available_workloads():
        tcls, jcls = TW.get_workload(name), JW.get_workload(name)
        assert (tcls.phases, tcls.__name__) == (jcls.phases, jcls.__name__)
    (mesh,) = TW.build_validators(["mesh"], TW.WorkloadContext(budget_bits=BUDGET,
                                                               device="cpu"))
    assert mesh.threshold == BUDGET and mesh.run(TD.FDP91).mesh == "1x1"   # a world of 1
    with pytest.raises(KeyError, match="unknown workload"):
        TW.get_workload("nope")
    with pytest.raises(ValueError, match="model-bound"):
        TW.build_validators(["grad"], TW.WorkloadContext(budget_bits=BUDGET, device="cpu"))
    vs = TW.build_validators(["solve", "repro"], TW.WorkloadContext(budget_bits=BUDGET,
                                                                   device="cpu"))
    assert [v.name for v in vs] == ["solve", "repro"] and all(v.threshold == BUDGET for v in vs)


@pytest.mark.parametrize("mesh", [None, "2x4"])
def test_report_json_and_describe_equal(mesh):
    kw = dict(workload="x", score=np.float64(12.5), threshold=10.0,
              site_attribution={"a": np.float32(1.5), "*@bwd": 3.0},
              details={"inf": float("inf"), "n": 3, "v": np.float32(2.25)}, mesh=mesh)
    j, t = JW.ValidationReport(**kw), TW.ValidationReport(**kw)
    assert t.to_json() == j.to_json() and t.describe() == j.describe()
    failing = dict(kw, score=float("nan"))
    assert TW.ValidationReport(**failing).to_json() == JW.ValidationReport(**failing).to_json()
    meta = tload(PAPER_PLAN).meta
    assert TW.validation_summary(meta) == JW.validation_summary(jload(PAPER_PLAN).meta)


SITE_KEYS = ["attn_qk", "attn_qk@bwd.dA", "attn_qk@bwd.dB", "mlp_in", "mlp_in@bwd.dB",
             "lm_head", "lm_head@bwd.dA", "opt.m@state", "opt.v@state", "grad_psum@coll"]
ATTRIBUTIONS = [{}, {"*@bwd": 1.0}, {"attn_qk": 1.0}, {"mlp_*@bwd.dB": 1.0},
                {"attn_qk@*": 1.0, "lm_head": 2.0}, {"opt.m@state": 1.0},
                {"*@state": 1.0, "*@coll": 1.0}, {"grad_psum@coll": 1.0, "mlp_in": 3.0}]


def test_eligible_site_equal_on_a_grid():
    for name in TW.available_workloads():
        tcls, jcls = TW.get_workload(name), JW.get_workload(name)
        tv, jv = tcls.__new__(tcls), jcls.__new__(jcls)      # eligibility reads phases only
        for attribution in ATTRIBUTIONS:
            rep_t = TW.ValidationReport(name, 1.0, 2.0, site_attribution=attribution)
            rep_j = JW.ValidationReport(name, 1.0, 2.0, site_attribution=attribution)
            for key in SITE_KEYS:
                assert tv.eligible_site(key, rep_t) == jv.eligible_site(key, rep_j), \
                    (name, key, attribution)


def test_probed_sites_and_bwd91_reference_equal():
    jpol, tpol = _policies(FP32_NATIVE, [
        ("attn_qk", NARROW), ("attn_qk@bwd.dA", NARROW), ("mlp_in@*", BF16_SIM),
        ("mlp_*", NARROW), ("lm_head@bwd", BF16_SIM), ("*@bwd", NARROW),
        ("attn_v@bwd.dB", FP32_NATIVE)])
    assert TW.probed_sites(tpol) == JW.probed_sites(jpol) == [
        "attn_qk", "attn_qk@bwd.dA", "lm_head@bwd", "attn_v@bwd.dB"]
    assert TW.probed_sites(TD.MXU_FP32) == JW.probed_sites(JD.MXU_FP32) == []
    tpl, jpl = tload(PAPER_PLAN).to_policy(), jload(PAPER_PLAN).to_policy()
    assert TW.probed_sites(tpl) == JW.probed_sites(jpl) and len(TW.probed_sites(tpl)) == 30
    sites = ["attn_qk", "attn_qk@bwd.dA", "attn_qk@bwd.dB", "mlp_in", "mlp_in@bwd.dA",
             "mlp_gate@bwd.dB", "lm_head", "lm_head@bwd.dA", "attn_v@bwd.dB", "other",
             "other@bwd.dA"]
    for pols in ((jpol, tpol), (jpl, tpl), (JD.FDP91, TD.FDP91), (JD.MXU_FP32, TD.MXU_FP32)):
        jref = JW.bwd91_reference_policy(pols[0])
        tref = TW.bwd91_reference_policy(pols[1])
        assert tref.name == jref.name
        assert [tref.lookup(s).tag() for s in sites] == [jref.lookup(s).tag() for s in sites]
        kern = TW.bwd91_reference_policy(pols[1], "pallas")
        assert [kern.lookup(s).tag() for s in sites] == \
            [jref.lookup(s).tag().replace("/simulate", "/pallas") if "@bwd" in s
             else jref.lookup(s).tag() for s in sites]


# ---------------------------------------------------------------------------
# synthetic workloads
# ---------------------------------------------------------------------------
def _run_both(name, jpol, tpol, **kw):
    jv = JW.get_workload(name)(threshold=BUDGET, **kw)
    tv = TW.get_workload(name)(threshold=BUDGET, device="cpu", **kw)
    return jv.run(jpol).to_json(), tv.run(tpol).to_json()


@pytest.mark.parametrize("name,kw", [("solve", dict(conds=(1e4, 1e8), seed=2)),
                                     ("repro", dict(seed=3))])
def test_synthetic_workloads_bit_equal_under_simulate(name, kw):
    jpol, tpol = _policies(SIM91, [("s_wide", ("ieee_fp32", (30, 30, -50), "simulate")),
                                   ("s_narrow@bwd.dA", NARROW), ("s_bf16", BF16_SIM)])
    j, t = _run_both(name, jpol, tpol, **kw)
    assert t == j, (t, j)
    assert set(t["site_attribution"]) == {"s_wide", "s_narrow@bwd.dA", "s_bf16"}
    if name == "repro":
        assert t["score"] == 53.0                      # FDP is bit-stable under reordering


@pytest.mark.parametrize("name,kw", [("solve", dict(conds=(1e4,), seed=1)),
                                     ("repro", dict(seed=0))])
def test_synthetic_workloads_native_within_tolerance(name, kw):
    jpol, tpol = _policies(FP32_NATIVE, [("n1", FP32_NATIVE), ("n2@bwd.dB", FP32_NATIVE)])
    j, t = _run_both(name, jpol, tpol, **kw)
    assert abs(t["score"] - j["score"]) <= NATIVE_BITS_TOL
    assert t["site_attribution"].keys() == j["site_attribution"].keys()
    for k in t["site_attribution"]:
        assert abs(t["site_attribution"][k] - j["site_attribution"][k]) <= NATIVE_BITS_TOL
    if name == "repro":
        assert 10.0 < t["score"] < 30.0               # native drifts under reordering


# ---------------------------------------------------------------------------
# quant_opt, the CLI, the gradient scoring
# ---------------------------------------------------------------------------
def _carry(jctx, cfg):
    """The reference context's parameters and batches as the port's, on the CPU."""
    params = params_from_numpy(jax.tree.map(np.asarray, jctx.params), cfg, device="cpu")
    conv = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    return TW.WorkloadContext(budget_bits=jctx.budget_bits, cfg=cfg, params=params,
                              batch=conv(jctx.batch), grad_batch=conv(jctx.grad_batch),
                              seed=jctx.seed, device="cpu")


def test_quant_opt_matches_the_reference_and_leaves_the_params():
    jctx = JW.WorkloadContext.for_model(jget("paper-mlp").reduced(), budget_bits=BUDGET, seed=0)
    tctx = _carry(jctx, tget("paper-mlp").reduced())
    before = {k: p.detach().clone() for k, p in tctx.params.named_parameters()}
    aux = (("opt.m@state", "8x64"), ("opt.v@state", "8x64"))
    for jpol, tpol in (_policies(FP32_NATIVE, [], aux, name="q8"),
                       _policies(FP32_NATIVE, [], (("opt.m@state", "4x32"),
                                                   ("opt.v@state", "4x32")), name="q4")):
        [jv] = JW.build_validators(["quant_opt"], jctx)
        [tv] = TW.build_validators(["quant_opt"], tctx)
        j, t = jv.run(jpol).to_json(), tv.run(tpol).to_json()
        assert t["site_attribution"].keys() == j["site_attribution"].keys()
        assert t["details"]["state_formats"] == j["details"]["state_formats"]
        for tb, jb in zip(t["details"]["per_step_bits"], j["details"]["per_step_bits"]):
            assert abs(tb - jb) <= QUANT_OPT_BITS_TOL, (t, j)
        assert all(math.isfinite(x) for x in t["details"]["loss_curve"])
        for k, p in tctx.params.named_parameters():
            assert torch.equal(p, before[k]), k          # every curve trains a copy
    # the reference curve is cached on the GEMM surface: a second run reuses it
    ref = tv._ref_val
    tv.run(tpol)
    assert tv._ref_val is ref


def test_cli_on_the_cpu_holds_the_recorded_evidence(capsys):
    TWM.main(["--plan", PAPER_PLAN, "--device", "cpu", "--tolerance", "2"])
    out = capsys.readouterr().out
    assert "[workloads] OK: 3 workload(s) ran" in out and "device cpu" in out
    with pytest.raises(SystemExit):
        TWM.main(["--plan", PAPER_PLAN, "--device", "cpu", "--validators", "logits",
                  "--tolerance", "2", "--require-pass", "--budget", "30"])


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1001])
def test_grad_scoring_on_the_device_equals_the_numpy_formula(n):
    rng = np.random.default_rng(n)
    ref = rng.standard_normal(n).astype(np.float32)
    got = (ref * (1 + rng.standard_normal(n) * 10.0 ** rng.integers(-9, 0, n))).astype(np.float32)
    got[::5] = ref[::5]                                # exact entries score at the cap
    ref[::11] = 0.0                                    # zero references
    want = JM.correct_bits(got, ref, cap=24.0)
    bits = TWG.correct_bits_t(torch.from_numpy(got), torch.from_numpy(ref), 24.0)
    assert bits.dtype == torch.float64
    np.testing.assert_allclose(bits.numpy(), want, rtol=0, atol=SCORING_TOL)
    assert TWG.median_t(torch.from_numpy(want)) == float(np.median(want))
    assert abs(TWG.median_t(bits) - float(np.median(want))) <= SCORING_TOL


def test_grad_leaves_are_the_reference_tree():
    """The port's per-layer gradients group, stack and name as the
    reference's tree leaves do."""
    cfg = tget("qwen3-0.6b").reduced()
    ctx = TW.WorkloadContext.for_model(cfg, device="cpu")
    named = list(ctx.params.named_parameters())
    fake = [torch.full_like(p, float(i)) for i, (_, p) in enumerate(named)]
    leaves = TWG.named_leaves(ctx.params, fake)
    from repro_torch.models import params_to_numpy
    tree = params_to_numpy({k: g for (k, _), g in zip(named, fake)}, cfg)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [k for k, _ in leaves] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, got), (_, w) in zip(leaves, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w).ravel())


def test_probe_batches_are_seeded_and_shared():
    cfg = tget("paper-mlp").reduced()
    a = TW.make_probe_batch(cfg, batch_size=2, seq=8, seed=1, device="cpu")
    b = TW.make_probe_batch(cfg, batch_size=2, seq=8, seed=1, with_targets=True, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].shape == (2, 8)
    assert set(b) == {"tokens", "targets", "loss_mask"}
    assert int(b["targets"].max()) < cfg.vocab_size and b["loss_mask"].dtype == torch.float32
    # the dense family's draws: tokens, then targets, from one generator
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(b["tokens"], torch.randint(0, cfg.vocab_size, (2, 8), generator=gen))
    assert torch.equal(b["targets"], torch.randint(0, cfg.vocab_size, (2, 8), generator=gen))
    # the reference's extras: vlm patches and encdec frames, 0.5 x normal,
    # the same with or without targets and for the same seed
    for arch, key, rows in (("paligemma-3b", "patches", "n_patches"),
                            ("whisper-large-v3", "frames", "enc_seq")):
        fcfg = tget(arch).reduced()
        x = TW.make_probe_batch(fcfg, batch_size=3, seq=5, seed=2, device="cpu")
        y = TW.make_probe_batch(fcfg, batch_size=3, seq=5, seed=2, with_targets=True,
                                device="cpu")
        z = TW.make_probe_batch(fcfg, batch_size=3, seq=5, seed=4, device="cpu")
        assert set(x) == {"tokens", key} and set(y) == {"tokens", key, "targets", "loss_mask"}
        assert x[key].shape == (3, getattr(fcfg, rows), fcfg.d_model)
        assert x[key].dtype == torch.float32
        assert torch.equal(x[key], y[key]) and torch.equal(x["tokens"], y["tokens"])
        assert not torch.equal(x[key], z[key])
        assert 0.4 < float(x[key].std()) < 0.6
