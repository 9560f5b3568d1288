"""The port's sorted-segment grouped GEMM against the JAX reference.

``dispatch.ragged_gemm`` in ``simulate`` mode and in ``pallas`` mode (on
the CPU the kernel wrapper runs its plain version) must be bit-equal to
JAX's ``repro.kernels.ops.fdp_ragged_gemm`` (Pallas in interpret mode) and
to JAX's ``ragged_gemm`` in ``simulate`` mode, for every format, round mode
and overflow mode, with zero-size groups (leading and trailing ones among
them) and rows past ``sum(group_sizes)``. Native mode agrees with
``jax.lax.ragged_dot`` within f32 reordering error. The kernel itself is
held against the plain version on the card in ``test_torch_kernel_cuda.py``
and ``chip_smoke.py``.

JAX's ``simulate`` mode is compiled anew for every spec and shape, so it is
run for the f32 cases only; ``tests/test_ragged_segment.py`` holds it
bit-equal to the interpret-mode kernel, against which every case runs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

torch.set_num_threads(1)

SPEC_ARGS = {
    "trunc_wrap": dict(ovf=30, msb=30, lsb=-30),
    "rne_wrap": dict(ovf=30, msb=30, lsb=-30, round_mode="rne"),
    "trunc_saturate": dict(ovf=2, msb=5, lsb=-18, overflow_mode="saturate"),
    "rne_saturate": dict(ovf=2, msb=5, lsb=-18, round_mode="rne",
                         overflow_mode="saturate"),
}
# (T, d, f, group_sizes): sum(group_sizes) < T leaves padding rows
GROUPS = {
    "empty_lead_trail_padded": (40, 37, 11, [0, 9, 0, 14, 7, 0]),
    "one_group": (24, 20, 9, [0, 0, 24, 0]),
    "all_empty": (8, 16, 8, [0, 0, 0]),
    "odd_even": (33, 7, 33, [10, 0, 23]),
}


def _operands(T, d, f, E, fmt_name, seed):
    """Same numpy inputs for both packages: float formats on their grid,
    posit formats as int32 patterns."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) * 3).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) * 3).astype(np.float32)
    jf, tf = jfmt.get_format(fmt_name), tfmt.get_format(fmt_name)
    if isinstance(jf, jfmt.PositFormat):
        x, w = (np.asarray(jf.from_float(jnp.asarray(v))) for v in (x, w))
    else:
        x, w = (np.asarray(jf.quantize(jnp.asarray(v))) for v in (x, w))
    return x, w, jf, tf


def _bits(x):
    return np.asarray(x).view(np.int32)


def _policies(mode, fmt_name, spec_name):
    args = SPEC_ARGS[spec_name]
    jf, tf = jfmt.get_format(fmt_name), tfmt.get_format(fmt_name)
    return (JD.NumericsPolicy(JD.GemmConfig(jf, jacc.AccumulatorSpec(**args), mode)),
            TD.NumericsPolicy(TD.GemmConfig(tf, tacc.AccumulatorSpec(**args), mode)))


def _check_all_paths(T, d, f, gs, fmt_name, spec_name, seed, jax_simulate=False):
    x, w, jf, tf = _operands(T, d, f, len(gs), fmt_name, seed)
    jgs, tgs = jnp.asarray(gs, jnp.int32), torch.tensor(gs, dtype=torch.int32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x.copy()), torch.from_numpy(w.copy())
    js = jacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
    want = _bits(jops.fdp_ragged_gemm(jx, jw, jgs, spec=js, fmt=jf))
    if jax_simulate:
        jsim, _ = _policies("simulate", fmt_name, spec_name)
        with JD.use_policy(jsim):
            np.testing.assert_array_equal(_bits(JD.ragged_gemm(jx, jw, jgs, site="t")),
                                          want)
    launches = tk.fdp_ragged_gemm.launches
    for mode in ("simulate", "pallas"):
        _, tpol = _policies(mode, fmt_name, spec_name)
        with TD.use_policy(tpol):
            got = TD.ragged_gemm(tx, tw, tgs, site="t")
        assert got.shape == (T, f) and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), want, err_msg=mode)
    ts = tacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
    np.testing.assert_array_equal(
        _bits(tops.fdp_ragged_gemm(tx, tw, tgs, spec=ts, fmt=tf).numpy()), want)
    assert tk.fdp_ragged_gemm.launches == launches        # CPU tensors: no launch
    return want


@pytest.mark.parametrize("spec_name", list(SPEC_ARGS))
@pytest.mark.parametrize("fmt_name", ["ieee_fp32", "bfloat16", "posit16_1"])
def test_ragged_bit_equal_across_numerics(fmt_name, spec_name):
    T, d, f, gs = GROUPS["empty_lead_trail_padded"]
    want = _check_all_paths(T, d, f, gs, fmt_name, spec_name, seed=len(spec_name),
                            jax_simulate=fmt_name == "ieee_fp32")
    assert np.all(want[sum(gs):] == 0)                     # padding rows are +0.0
    if "saturate" in spec_name:
        top = np.float32((2 ** (5 + 2 + 18) - 1) * 2.0 ** -18)   # W = 26 bits
        assert np.any(want.view(np.float32) == top) or np.any(
            want.view(np.float32) == -(2 ** 25) * np.float32(2.0 ** -18))


@pytest.mark.parametrize("groups", ["one_group", "all_empty", "odd_even"])
def test_ragged_bit_equal_across_groupings(groups):
    T, d, f, gs = GROUPS[groups]
    want = _check_all_paths(T, d, f, gs, "ieee_fp32", "trunc_wrap", seed=3)
    if groups == "all_empty":
        assert not want.any()


def test_native_within_reordering_error():
    T, d, f, gs = GROUPS["empty_lead_trail_padded"]
    x, w, _, _ = _operands(T, d, f, len(gs), "ieee_fp32", seed=5)
    jpol = JD.NumericsPolicy(JD.GemmConfig(jfmt.FP32, None, "native"))
    tpol = TD.NumericsPolicy(TD.GemmConfig(tfmt.FP32, None, "native"))
    with JD.use_policy(jpol):
        want = np.asarray(JD.ragged_gemm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(gs, jnp.int32), site="t"))
    TD.reset_sites_seen()
    with TD.use_policy(tpol):
        got = TD.ragged_gemm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.tensor(gs, dtype=torch.int32), site="moe_in")
    assert TD.site_calls() == {"moe_in": 1}
    TD.reset_sites_seen()
    seg = np.repeat(np.arange(len(gs)), gs)
    bound = np.zeros((T, f))
    for t, e in enumerate(seg):                # |error| of an f32 dot in any order
        bound[t] = d * 2.0 ** -24 * (np.abs(x[t]).astype(np.float64) @ np.abs(w[e]))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= bound + 1e-6 * np.abs(want))
    assert not got[sum(gs):].any() and not want[sum(gs):].any()


@pytest.mark.parametrize("gs,T", [([0, 9, 0, 14, 7, 0], 40), ([3], 3), ([0, 0], 5)])
def test_segment_ids_and_fit_match(gs, T):
    want = np.asarray(JD._segment_ids(jnp.asarray(gs, jnp.int32), T))
    got = TD._segment_ids(torch.tensor(gs, dtype=torch.int32), T)
    np.testing.assert_array_equal(got.numpy(), want)
    for plan in ((32, 32, 128), (8, 64, 16)):
        jp = JD._fit_ragged(JD.GemmPlan(*plan), "bm", T, len(gs))
        tp = TD._fit_ragged(TD.GemmPlan(*plan), "bm", T, len(gs))
        assert jp.tile == tp.tile


def test_ragged_wrapper_checks_its_inputs():
    ts = tacc.AccumulatorSpec.paper_91bit()
    x, w = torch.zeros(4, 8), torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="group_sizes"):
        tk.fdp_ragged_gemm(x, w, torch.zeros(3, dtype=torch.int32), spec=ts, fmt=tfmt.FP32)
    with pytest.raises(ValueError, match="w \\(E,d,f\\)"):
        tk.fdp_ragged_gemm(x, torch.zeros(2, 7, 3), torch.zeros(2, dtype=torch.int32),
                           spec=ts, fmt=tfmt.FP32)
    with pytest.raises(TypeError, match="integers"):
        tk.fdp_ragged_gemm(x, w, torch.zeros(2), spec=ts, fmt=tfmt.FP32)
    with pytest.raises(TypeError, match="int32"):
        tk.fdp_ragged_gemm(x, w, torch.zeros(2, dtype=torch.int32), spec=ts,
                           fmt=tfmt.POSIT16_1)
    with pytest.raises(TypeError, match="GemmPlan"):
        tops.fdp_ragged_gemm(x, w, torch.tensor([4, 0]), spec=ts, plan=(8, 8, 8))
    # int64 sizes are taken; the plan is checked and changes nothing
    out = tops.fdp_ragged_gemm(x + 1, w + 1, torch.tensor([1, 2]), spec=ts,
                               plan=TD.GemmPlan(8, 8, 8))
    assert out.tolist() == [[8.0] * 3] * 3 + [[0.0] * 3]
