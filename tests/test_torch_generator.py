"""The kernel generator, its datapath model and the quality metrics in the
port against ``repro.core.{generator,energy,metrics}``, and the seed-order
kernel (``ops.fdp_gemm(impl="loop")``, TPU kernel ``fdp_gemm_kernel_looped``)
against the reference's.

On the CPU the port's ``pallas`` target and its ``impl="loop"`` run their
plain versions; the reference runs its Pallas kernels in interpret mode, as
its own tests do. Everything that goes through the limb register is
compared bit for bit; ``native`` within rtol 1e-6 (f32 sums in another
order); the energy model to 1e-12."""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import fdp as jfdp  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.core import generator as jgen  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core.dispatch import GemmPlan as JPlan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import fdp as tfdp  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core import generator as tgen  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core.dispatch import GemmPlan as TPlan  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

torch.set_num_threads(1)

SPECS = {
    "paper_91bit": dict(ovf=30, msb=30, lsb=-30),
    "fig3_9_6_-20": dict(ovf=9, msb=6, lsb=-20),
    "rne": dict(ovf=30, msb=30, lsb=-30, round_mode="rne"),
    "saturate": dict(ovf=2, msb=5, lsb=-18, overflow_mode="saturate"),
}


def _specs(name):
    return jacc.AccumulatorSpec(**SPECS[name]), tacc.AccumulatorSpec(**SPECS[name])


def _operands(m, k, n, fmt_name, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) * scale).astype(np.float32)
    b = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    jf = jfmt.get_format(fmt_name)
    if isinstance(jf, jfmt.PositFormat):
        a, b = jf.from_float(jnp.asarray(a)), jf.from_float(jnp.asarray(b))
    else:
        a, b = jf.quantize(jnp.asarray(a)), jf.quantize(jnp.asarray(b))
    return np.array(a), np.array(b)                 # writable copies


def _bits(x):
    return np.asarray(x).view(np.int32)


# -- energy -------------------------------------------------------------------
def test_energy_constants_and_paper_points_equal_the_reference():
    for name in ("ALPHA", "BETA_FMA", "BETA_FDP", "GAMMA", "FREQ_HZ",
                 "TPU_PJ_PER_MXU_MAC", "TPU_PJ_PER_VPU_OP"):
        assert getattr(tenergy, name) == pytest.approx(getattr(jenergy, name), abs=1e-12)
    assert tenergy.PAPER_POINTS.keys() == jenergy.PAPER_POINTS.keys()
    for key, (model, paper) in tenergy.PAPER_POINTS.items():
        assert model == pytest.approx(jenergy.PAPER_POINTS[key][0], abs=1e-12)
        assert paper == jenergy.PAPER_POINTS[key][1]
        assert model == pytest.approx(paper, abs=1e-9)


@pytest.mark.parametrize("fmt_name", ["ieee_fp32", "bfloat16", "ieee_fp16", "posit16_1"])
def test_energy_equals_the_reference_over_a_grid_of_specs(fmt_name):
    jf, tf = jfmt.get_format(fmt_name), tfmt.get_format(fmt_name)
    for ovf, msb, lsb in itertools.product((0, 2, 9, 30), (4, 6, 30), (-6, -20, -30, -60)):
        js, ts = jacc.AccumulatorSpec(ovf, msb, lsb), tacc.AccumulatorSpec(ovf, msb, lsb)
        for jr, tr in ((jenergy.spec_power(jf, js), tenergy.spec_power(tf, ts)),
                       (jenergy.gemm_power(jf, js), tenergy.gemm_power(tf, ts))):
            assert tr.kind == jr.kind
            for f in ("watts", "alpha_term", "beta_term", "gamma"):
                assert getattr(tr, f) == pytest.approx(getattr(jr, f), abs=1e-12)
            assert tr.energy_joules(12345, 2) == pytest.approx(jr.energy_joules(12345, 2),
                                                                abs=1e-12)
        assert tenergy.tpu_fdp_pj_per_mac(tf.precision, ts.num_limbs) == \
            jenergy.tpu_fdp_pj_per_mac(jf.precision, js.num_limbs)
    assert tenergy.gemm_power(tf).watts == pytest.approx(jenergy.gemm_power(jf).watts,
                                                         abs=1e-12)


# -- the generator's reports ----------------------------------------------------
def _report_fields(rep):
    d = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    s = d.pop("spec")
    d["spec"] = (s.ovf, s.msb, s.lsb, s.round_mode, s.overflow_mode)
    return d


REPORT_CASES = [(spec, fmt, target, tile)
                for spec in (None, "paper_91bit", "fig3_9_6_-20")
                for fmt in ("ieee_fp32", "bfloat16", "posit16_1")
                for target in ("native", "simulate", "pallas")
                for tile in (None, (32, 32, 128))
                if not (fmt == "posit16_1" and (spec is None or target == "native"))]


@pytest.mark.parametrize("spec,fmt,target,tile", REPORT_CASES)
def test_reports_equal_the_reference_field_for_field(spec, fmt, target, tile):
    js, ts = _specs(spec) if spec else (None, None)
    want = jgen.datapath_report(js, fmt, target, tile)
    got = tgen.datapath_report(ts, fmt, target, tile)
    assert _report_fields(got) == _report_fields(want)
    assert got.describe() == want.describe()
    if spec is not None or target == "native":
        gen = tgen.generate_gemm(ts, fmt, target, tile)
        assert _report_fields(gen.report) == \
            _report_fields(jgen.generate_gemm(js, fmt, target, tile).report)


def test_native_target_refuses_posits_and_unknown_targets_raise():
    with pytest.raises(ValueError, match="native"):
        tgen.generate_gemm(None, "posit16_1", "native")
    with pytest.raises(ValueError, match="unknown target"):
        tgen.generate_gemm(tacc.AccumulatorSpec.paper_91bit(), "ieee_fp32", "fpga")


# -- the generator's kernels ----------------------------------------------------
GEN_CASES = [("paper_91bit", "ieee_fp32", (64, 256, 32)),
             ("fig3_9_6_-20", "ieee_fp32", (24, 96, 40)),
             ("rne", "bfloat16", (17, 70, 9)),
             ("saturate", "posit16_1", (8, 64, 24))]


@pytest.mark.parametrize("spec,fmt,shape", GEN_CASES)
@pytest.mark.parametrize("tile", [None, (32, 32, 128)])
def test_generated_fdp_gemms_bit_equal_the_reference(spec, fmt, shape, tile):
    js, ts = _specs(spec)
    a, b = _operands(*shape, fmt, seed=sum(shape), scale=2.0)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    want_sim = np.asarray(jgen.generate_gemm(js, fmt, "simulate", tile).fn(ja, jb))
    for target in ("simulate", "pallas"):
        got = tgen.generate_gemm(ts, fmt, target, tile).fn(ta, tb)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_sim), err_msg=target)
    if spec == "paper_91bit":             # the interpret-mode kernel once per tile
        want = np.asarray(jgen.generate_gemm(js, fmt, "pallas", tile).fn(ja, jb))
        np.testing.assert_array_equal(_bits(want), _bits(want_sim))


@pytest.mark.parametrize("fmt", ["ieee_fp32", "bfloat16"])
def test_generated_native_gemm_matches_the_reference(fmt):
    """rtol 1e-6, plus the bound of summing K f32 products in another order
    (K * 2^-24 * sum_k |a_mk b_kn| per output), which is what an output that
    cancels to near zero differs by."""
    a, b = _operands(64, 256, 32, fmt, seed=1)
    want = np.asarray(jgen.generate_gemm(None, fmt, "native").fn(jnp.asarray(a), jnp.asarray(b)))
    got = tgen.generate_gemm(None, fmt, "native").fn(torch.from_numpy(a), torch.from_numpy(b))
    reorder = a.shape[1] * 2.0 ** -24 * (np.abs(a).astype(np.float64) @ np.abs(b))
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * np.abs(want) + reorder)


# -- metrics ------------------------------------------------------------------
def test_metrics_equal_the_reference():
    rng = np.random.default_rng(2)
    ref = rng.standard_normal(64)
    val = (ref * (1 + rng.standard_normal(64) * 2.0 ** -rng.integers(1, 60, 64))).astype(
        np.float64)
    val[:3] = ref[:3]                               # exact: capped
    np.testing.assert_array_equal(tmetrics.correct_bits(val, ref),
                                  jmetrics.correct_bits(val, ref))
    np.testing.assert_array_equal(tmetrics.correct_bits(torch.from_numpy(val), ref, cap=24.0),
                                  jmetrics.correct_bits(val, ref, cap=24.0))
    a = rng.standard_normal(40).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    assert tmetrics.exact_dot_fraction(torch.from_numpy(a), b) == \
        jmetrics.exact_dot_fraction(a, b)
    f = jmetrics.exact_dot_fraction(a, b)
    assert tmetrics.fraction_to_float(f) == jmetrics.fraction_to_float(f)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    other = logits + rng.standard_normal((3, 5, 11)).astype(np.float32)
    assert tmetrics.top1_agreement(torch.from_numpy(logits), other) == \
        jmetrics.top1_agreement(logits, other)


def test_reproducibility_deviation_equals_the_reference():
    """Same permutations from the same seed; the FDP's deviation is 0.0 by
    construction and every permuted value is bit-equal across packages."""
    js, ts = _specs("paper_91bit")
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(200) * 2.0 ** rng.integers(-20, 20, 200)).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32)
    jdev, jvals = jmetrics.reproducibility_deviation(
        lambda x, y: jfdp.fdp_dot(x, y, js), a, b, n_orders=5, seed=4)
    tdev, tvals = tmetrics.reproducibility_deviation(
        lambda x, y: tfdp.fdp_dot(x, y, ts), torch.from_numpy(a), b, n_orders=5, seed=4)
    assert tdev == jdev == 0.0
    np.testing.assert_array_equal(tvals, jvals)


# -- the seed-order kernel (impl="loop") ------------------------------------------
LOOP_CASES = [("paper_91bit", "ieee_fp32", (40, 300, 24)),
              ("fig3_9_6_-20", "bfloat16", (16, 130, 20)),
              ("rne", "posit16_1", (9, 64, 33))]


@pytest.mark.parametrize("spec,fmt,shape", LOOP_CASES)
def test_loop_impl_bit_equal_to_the_reference(spec, fmt, shape):
    js, ts = _specs(spec)
    a, b = _operands(*shape, fmt, seed=len(fmt), scale=2.0)
    want = np.asarray(jops.fdp_gemm(jnp.asarray(a), jnp.asarray(b), spec=js,
                                    fmt=jfmt.get_format(fmt), plan=JPlan(32, 32, 128),
                                    impl="loop"))
    before = tk.fdp_gemm_looped.launches
    got = tops.fdp_gemm(torch.from_numpy(a), torch.from_numpy(b), spec=ts,
                        fmt=tfmt.get_format(fmt), plan=TPlan(32, 32, 128), impl="loop")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert tk.fdp_gemm_looped.launches == before          # CPU tensors: no launch
    vec = tops.fdp_gemm(torch.from_numpy(a), torch.from_numpy(b), spec=ts,
                        fmt=tfmt.get_format(fmt), impl="vector")
    np.testing.assert_array_equal(_bits(vec.numpy()), _bits(want))


def test_unknown_impl_raises_in_both_packages():
    a, b = _operands(8, 16, 8, "ieee_fp32", seed=0)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.fdp_gemm(torch.from_numpy(a), torch.from_numpy(b),
                      spec=tacc.AccumulatorSpec.paper_91bit(), impl="tiled")
    with pytest.raises(ValueError, match="unknown impl"):
        jops.fdp_gemm(jnp.asarray(a), jnp.asarray(b),
                      spec=jacc.AccumulatorSpec.paper_91bit(), impl="tiled")


def test_loop_wrapper_checks_its_plan_and_shapes():
    a = torch.ones(4, 8)
    spec = tacc.AccumulatorSpec.paper_91bit()
    with pytest.raises(ValueError, match="not fitted"):
        tk.fdp_gemm_looped(a, torch.ones(8, 4), TPlan(8, 8, 1 << 20), spec=spec,
                           fmt=tfmt.FP32)
    with pytest.raises(ValueError, match=r"\(M,K\) @ \(K,N\)"):
        tk.fdp_gemm_looped(a, torch.ones(7, 4), TPlan(8, 8, 8), spec=spec, fmt=tfmt.FP32)
    with pytest.raises(TypeError, match="GemmPlan"):
        tops.fdp_gemm(a, torch.ones(8, 4), spec=spec, plan=(8, 8, 8), impl="loop")
