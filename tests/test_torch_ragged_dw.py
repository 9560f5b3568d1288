"""The port's sorted-segment weight gradient (kernel 4) against the JAX
reference.

``ops.fdp_ragged_dw`` (on the CPU the kernel wrapper runs its plain
version, ``fdp_ragged_dw_plain``) and the port's ``simulate`` mode
(``core.fdp.fdp_ragged_dw``) must be bit-equal to JAX's
``repro.kernels.ops.fdp_ragged_dw`` (Pallas in interpret mode) for every
format, round mode and overflow mode, with zero-size groups (leading, inner
and trailing), rows past ``sum(group_sizes)``, one group holding every row,
and every group empty. The port's ``simulate`` dW is also held bit-equal to
the reference's ``simulate`` dW (the per-expert masked Aᵀ·G that
``jax.vjp`` of ``ragged_gemm`` runs). The kernel itself is held against the
plain version on the card in ``test_torch_kernel_cuda.py`` and
``chip_smoke.py``.

JAX's ``simulate`` mode compiles anew for every spec and shape, so it runs
for the f32 cases only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import fdp as tfdp  # noqa: E402
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
# (T, d, f, group_sizes): sum(group_sizes) < T leaves rows past the total
GROUPS = {
    "empty_lead_inner_trail_padded": (40, 13, 11, [0, 9, 0, 14, 7, 0]),
    "one_group": (24, 9, 10, [0, 0, 24, 0]),
    "all_empty": (8, 6, 8, [0, 0, 0]),
    "odd_even": (33, 7, 12, [10, 0, 23]),
}


def _operands(T, d, f, fmt_name, seed):
    """Same numpy inputs for both packages: float formats on their grid,
    posit formats as int32 patterns."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) * 3).astype(np.float32)
    g = (rng.standard_normal((T, f)) * 3).astype(np.float32)
    jf, tf = jfmt.get_format(fmt_name), tfmt.get_format(fmt_name)
    if isinstance(jf, jfmt.PositFormat):
        x, g = (np.asarray(jf.from_float(jnp.asarray(v))) for v in (x, g))
    else:
        x, g = (np.asarray(jf.quantize(jnp.asarray(v))) for v in (x, g))
    return x, g, jf, tf


def _bits(x):
    return np.asarray(x).view(np.int32)


def _reference_simulate_dw(x, g, gs, spec_args):
    """The reference's simulate-mode dW: the w-cotangent of ``jax.vjp`` of
    ``ragged_gemm`` with the forward's output cotangent ``g``."""
    E, d, f = len(gs), x.shape[1], g.shape[1]
    cfg = JD.GemmConfig(jfmt.FP32, jacc.AccumulatorSpec(**spec_args), "simulate")
    pol = JD.NumericsPolicy(cfg)
    w = jnp.zeros((E, d, f), jnp.float32)
    _, vjp = jax.vjp(lambda w_: JD.ragged_gemm(jnp.asarray(x), w_, jnp.asarray(gs, jnp.int32),
                                               site="t", policy=pol), w)
    return vjp(jnp.asarray(g))[0]


def _check(T, d, f, gs, fmt_name, spec_name, seed, jax_simulate=False):
    x, g, jf, tf = _operands(T, d, f, fmt_name, seed)
    E = len(gs)
    js = jacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
    ts = tacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
    want = _bits(jops.fdp_ragged_dw(jnp.asarray(x), jnp.asarray(g), jnp.asarray(gs, jnp.int32),
                                    num_groups=E, spec=js, fmt=jf, interpret=True))
    assert want.shape == (E, d, f)
    if jax_simulate:
        np.testing.assert_array_equal(
            _bits(_reference_simulate_dw(x, g, gs, SPEC_ARGS[spec_name])), want)
    tx, tg = torch.from_numpy(x.copy()), torch.from_numpy(g.copy())
    tgs = torch.tensor(gs, dtype=torch.int32)
    launches = tk.fdp_ragged_dw.launches
    got = tops.fdp_ragged_dw(tx, tg, tgs, num_groups=E, spec=ts, fmt=tf)
    assert got.shape == (E, d, f) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    np.testing.assert_array_equal(
        _bits(tk.fdp_ragged_dw_plain(tx, tg, tgs, spec=ts, fmt=tf).numpy()), want)
    np.testing.assert_array_equal(_bits(tfdp.fdp_ragged_dw(tx, tg, tgs, ts, tf).numpy()), want)
    assert tk.fdp_ragged_dw.launches == launches             # CPU tensors: no launch
    return want


@pytest.mark.parametrize("spec_name", list(SPEC_ARGS))
@pytest.mark.parametrize("fmt_name", ["ieee_fp32", "bfloat16", "posit16_1"])
def test_ragged_dw_bit_equal_across_numerics(fmt_name, spec_name):
    T, d, f, gs = GROUPS["empty_lead_inner_trail_padded"]
    want = _check(T, d, f, gs, fmt_name, spec_name, seed=len(spec_name),
                  jax_simulate=fmt_name == "ieee_fp32" and spec_name == "trunc_wrap")
    for e, n in enumerate(gs):
        if n == 0:                                        # exact +0.0 blocks
            assert not want[e].any()


@pytest.mark.parametrize("groups", ["one_group", "all_empty", "odd_even"])
def test_ragged_dw_bit_equal_across_groupings(groups):
    T, d, f, gs = GROUPS[groups]
    want = _check(T, d, f, gs, "ieee_fp32", "trunc_wrap", seed=3,
                  jax_simulate=groups == "one_group")
    if groups == "all_empty":
        assert not want.any()


def test_rows_past_the_total_add_nothing():
    """Garbage in the rows past sum(group_sizes) does not reach dW."""
    T, d, f, gs = GROUPS["empty_lead_inner_trail_padded"]
    x, g, _, tf = _operands(T, d, f, "ieee_fp32", seed=11)
    ts = tacc.AccumulatorSpec(**SPEC_ARGS["trunc_wrap"])
    tgs = torch.tensor(gs, dtype=torch.int32)
    base = tops.fdp_ragged_dw(torch.from_numpy(x.copy()), torch.from_numpy(g.copy()), tgs,
                              num_groups=len(gs), spec=ts, fmt=tf)
    x2, g2 = x.copy(), g.copy()
    x2[sum(gs):], g2[sum(gs):] = 1e30, -7.0
    again = tops.fdp_ragged_dw(torch.from_numpy(x2), torch.from_numpy(g2), tgs,
                               num_groups=len(gs), spec=ts, fmt=tf)
    assert torch.equal(base, again)


def test_ragged_dw_wrapper_checks_its_inputs():
    ts = tacc.AccumulatorSpec.paper_91bit()
    x, g = torch.ones(4, 3), torch.ones(4, 2)
    with pytest.raises(ValueError, match="num_groups|\\(3,\\)"):
        tops.fdp_ragged_dw(x, g, torch.tensor([2, 2]), num_groups=3, spec=ts)
    with pytest.raises(ValueError, match="g \\(T,f\\)"):
        tk.fdp_ragged_dw(x, torch.ones(5, 2), torch.tensor([4]), spec=ts, fmt=tfmt.FP32)
    with pytest.raises(TypeError, match="integers"):
        tk.fdp_ragged_dw(x, g, torch.tensor([4.0]), spec=ts, fmt=tfmt.FP32)
    with pytest.raises(TypeError, match="GemmPlan"):
        tops.fdp_ragged_dw(x, g, torch.tensor([4]), num_groups=1, spec=ts, plan=(8, 8, 8))
    out = tops.fdp_ragged_dw(x, g, torch.tensor([1, 0, 3]), num_groups=3, spec=ts,
                             plan=TD.GemmPlan(8, 8, 8))
    assert out.tolist() == [[[1.0] * 2] * 3, [[0.0] * 2] * 3, [[3.0] * 2] * 3]
