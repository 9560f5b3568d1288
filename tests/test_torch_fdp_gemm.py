"""The port's FDP GEMM entry points against the JAX reference.

On the CPU the kernel wrapper runs its plain version, which must be
bit-equal to ``repro.kernels.ops`` (Pallas in interpret mode) and to
``repro.core.fdp.fdp_gemm`` for every format, round mode and overflow mode.
The kernel itself is held against the plain version on the card in
``test_torch_kernel_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import fdp as jfdp  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core.dispatch import GemmPlan as TPlan  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

SPEC_ARGS = {
    "paper_91bit": dict(ovf=30, msb=30, lsb=-30),
    "rne": dict(ovf=30, msb=30, lsb=-30, round_mode="rne"),
    "saturate": dict(ovf=2, msb=5, lsb=-18, overflow_mode="saturate"),
}


def _spec(name):
    return jacc.AccumulatorSpec(**SPEC_ARGS[name]), tacc.AccumulatorSpec(**SPEC_ARGS[name])


def _operands(shape_a, shape_b, fmt_name, seed):
    """Same numpy inputs for both packages: float formats on their grid,
    posit formats as int32 patterns."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape_a) * 3).astype(np.float32)
    b = (rng.standard_normal(shape_b) * 3).astype(np.float32)
    jf, tf = jfmt.get_format(fmt_name), tfmt.get_format(fmt_name)
    if isinstance(jf, jfmt.PositFormat):
        a, b = np.asarray(jf.from_float(jnp.asarray(a))), np.asarray(jf.from_float(jnp.asarray(b)))
    else:
        a, b = np.asarray(jf.quantize(jnp.asarray(a))), np.asarray(jf.quantize(jnp.asarray(b)))
    return (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a.copy()), torch.from_numpy(b.copy())), jf, tf


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("B,M,K,N", [
    (3, 8, 32, 8),          # block-aligned
    (2, 17, 70, 9),         # nothing divides the blocks
    (4, 1, 128, 5),         # degenerate rows
    (1, 33, 257, 3),        # B=1
], ids=str)
def test_batched_bit_equal_to_interpret_pallas(B, M, K, N):
    (ja, jb), (ta, tb), jf, tf = _operands((B, M, K), (B, K, N), "ieee_fp32", seed=B * 1000 + K)
    js, ts = _spec("paper_91bit")
    want = jops.fdp_gemm_batched(ja, jb, spec=js, fmt=jf)
    got = tops.fdp_gemm_batched(ta, tb, spec=ts, fmt=tf, plan=TPlan(8, 8, 32))
    assert got.shape == (B, M, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("fmt_name,spec_name", [
    ("ieee_fp32", "paper_91bit"), ("ieee_fp32", "rne"), ("ieee_fp32", "saturate"),
    ("bfloat16", "paper_91bit"), ("bfloat16", "rne"),
    ("posit16_1", "paper_91bit"), ("posit16_1", "saturate"),
])
def test_formats_and_modes_bit_equal(fmt_name, spec_name):
    """2-D entry point vs Pallas interpret mode and vs core.fdp.fdp_gemm;
    the batched entry point vs core.fdp.fdp_gemm per batch element."""
    (ja, jb), (ta, tb), jf, tf = _operands((2, 9, 45), (2, 45, 6), fmt_name, seed=len(spec_name))
    js, ts = _spec(spec_name)
    got2 = tops.fdp_gemm(ta[0], tb[0], spec=ts, fmt=tf)
    np.testing.assert_array_equal(
        _bits(jops.fdp_gemm(ja[0], jb[0], spec=js, fmt=jf)),
        _bits(got2.numpy()))
    np.testing.assert_array_equal(_bits(jfdp.fdp_gemm(ja[0], jb[0], js, jf)), _bits(got2.numpy()))
    got3 = tops.fdp_gemm_batched(ta, tb, spec=ts, fmt=tf)
    for i in range(2):
        np.testing.assert_array_equal(_bits(jfdp.fdp_gemm(ja[i], jb[i], js, jf)),
                                      _bits(got3[i].numpy()))
    np.testing.assert_array_equal(_bits(got3[0].numpy()),
                                  _bits(tref.fdp_gemm_ref(ta[0], tb[0], spec=ts, fmt=tf).numpy()))


@pytest.mark.parametrize("shape_a,shape_b", [
    ((2, 1, 9, 33), (3, 33, 7)),     # broadcast leading dims
    ((33,), (2, 33, 7)),             # 1-D lhs
    ((9, 33), (33,)),                # 1-D rhs
    ((33,), (33,)),                  # vector . vector -> scalar
    ((4, 1, 64), (64, 11)),          # decode-shaped activation x 2-D weight
], ids=str)
def test_nd_bit_equal_to_interpret_pallas(shape_a, shape_b):
    (ja, jb), (ta, tb), jf, tf = _operands(shape_a, shape_b, "ieee_fp32", seed=len(shape_a) * 7)
    js, ts = _spec("paper_91bit")
    want = np.asarray(jops.fdp_gemm_nd(ja, jb, spec=js, fmt=jf))
    got = tops.fdp_gemm_nd(ta, tb, spec=ts, fmt=tf).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(want), _bits(got))


def test_weight_reaches_the_kernel_with_batch_stride_zero():
    """A 2-D weight broadcast against batched activations is a stride-0
    view, not B copies."""
    seen = []

    def f3d(a, b):
        seen.append((a.shape, b.shape, b.stride(), b.data_ptr()))
        return torch.zeros(a.shape[0], a.shape[1], b.shape[2])

    w = torch.randn(64, 11)
    out = tops.matmul_batching(None, f3d)(torch.randn(4, 3, 64), w)
    assert out.shape == (4, 3, 11)
    (_, b_shape, b_stride, ptr), = seen
    assert b_shape == (4, 64, 11) and b_stride[0] == 0 and ptr == w.data_ptr()


def test_wrapper_checks_its_inputs():
    ts = tacc.AccumulatorSpec.paper_91bit()
    with pytest.raises(ValueError, match="B,M,K"):
        tk.fdp_gemm(torch.zeros(2, 3), torch.zeros(3, 2), spec=ts, fmt=tfmt.FP32)
    with pytest.raises(TypeError, match="int32"):
        tk.fdp_gemm(torch.zeros(1, 2, 3), torch.zeros(1, 3, 2), spec=ts, fmt=tfmt.POSIT16_1)
    with pytest.raises(TypeError, match="GemmPlan"):
        tops.fdp_gemm_batched(torch.zeros(1, 2, 3), torch.zeros(1, 3, 2), spec=ts,
                              fmt=tfmt.FP32, plan=(8, 8, 32))
    # lm_head at decode: a weight broadcast over the batch is decoded once
    products = 4 * 1024 * 151936
    ops = tk.int32_ops(4 * 1024, 1024 * 151936, products)
    assert ops == 8 * (4 * 1024 + 1024 * 151936) + 20 * products
    assert ops < tk.int32_ops(4 * 1024, 1024 * 151936, products, rne=True)
