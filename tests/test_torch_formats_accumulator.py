"""The port's format front end and limb algebra against the JAX reference.

Every integer output (decoded fields, posit patterns, limb tensors) must be
bit-equal to ``repro.core``; read-out values must equal the Fraction oracle
in both round modes and both overflow modes."""

import zlib
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import fdp as tfdp  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402

from conftest import fdp_oracle, frac_to_f32_rne  # noqa: E402

torch.set_num_threads(1)

ROUND_OVERFLOW = [("trunc", "wrap"), ("rne", "wrap"), ("trunc", "saturate"),
                  ("rne", "saturate")]


def _specs(ovf, msb, lsb, round_mode="trunc", overflow_mode="wrap"):
    kw = dict(round_mode=round_mode, overflow_mode=overflow_mode)
    return jacc.AccumulatorSpec(ovf, msb, lsb, **kw), tacc.AccumulatorSpec(ovf, msb, lsb, **kw)


def _assert_decoded_equal(jd, td):
    for field in ("sign", "mant", "exp", "is_nan", "is_inf"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, field)),
                                      getattr(td, field).numpy(), err_msg=field)


def _f32_probe_values():
    rng = np.random.default_rng(11)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, 1e-45, -1e-45, 3e-39,
                        -2.5e-40, 65504.0, 65520.0, 1e5, 6e-8, 3.0e-5],
                       np.float32)
    bits = rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32)
    random_bits = bits.view(np.float32)
    normal = (rng.standard_normal(500) * 10.0 ** rng.integers(-30, 30, 500)).astype(np.float32)
    return np.concatenate([special, random_bits, normal])


@pytest.mark.parametrize("name", ["posit8_0", "posit16_1"])
def test_posit_decode_every_pattern(name):
    n = jfmt.get_format(name).nbits
    patterns = np.arange(1 << n, dtype=np.int32)
    jd = jfmt.get_format(name).decode(jnp.asarray(patterns))
    td = tfmt.get_format(name).decode(torch.from_numpy(patterns))
    _assert_decoded_equal(jd, td)


def test_posit32_decode_random_patterns():
    bits = np.random.default_rng(5).integers(0, 2 ** 32, 4000, dtype=np.uint64)
    patterns = bits.astype(np.uint32).view(np.int32)
    _assert_decoded_equal(jfmt.POSIT32_2.decode(jnp.asarray(patterns)),
                          tfmt.POSIT32_2.decode(torch.from_numpy(patterns)))


def test_float_decode_specials_and_subnormals():
    x = _f32_probe_values()
    _assert_decoded_equal(jfmt.FP32.decode(jnp.asarray(x)),
                          tfmt.FP32.decode(torch.from_numpy(x)))


@pytest.mark.parametrize("name", ["posit8_0", "posit16_1", "posit32_2"])
def test_posit_from_float_and_to_float(name):
    x = _f32_probe_values()
    jp = np.asarray(jfmt.get_format(name).from_float(jnp.asarray(x)))
    tp = tfmt.get_format(name).from_float(torch.from_numpy(x))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(jp, tp.numpy())
    if name != "posit32_2":   # posit32 significands round on their way to f32
        jv = np.asarray(jfmt.get_format(name).to_float(jnp.asarray(jp)))
        tv = tfmt.get_format(name).to_float(torch.from_numpy(np.array(jp))).numpy()
        np.testing.assert_array_equal(jv.view(np.int32), tv.view(np.int32))


@pytest.mark.parametrize("name", ["bfloat16", "ieee_fp16", "ieee_fp32"])
def test_float_quantize(name):
    x = _f32_probe_values()
    jq = np.asarray(jfmt.get_format(name).quantize(jnp.asarray(x)))
    tq = tfmt.get_format(name).quantize(torch.from_numpy(x)).numpy()
    nan = np.isnan(jq)
    np.testing.assert_array_equal(nan, np.isnan(tq))
    np.testing.assert_array_equal(jq[~nan].view(np.int32), tq[~nan].view(np.int32))


def _decoded_operands(shape_a, shape_b, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape_a) * scale).astype(np.float32)
    b = (rng.standard_normal(shape_b) * scale).astype(np.float32)
    a.flat[::7] = 0.0
    b.flat[::11] = np.float32(1e-40)            # subnormal operands
    b.flat[1::13] = np.inf                       # specials contribute nothing
    return ((jfmt.FP32.decode(jnp.asarray(a)), jfmt.FP32.decode(jnp.asarray(b))),
            (tfmt.FP32.decode(torch.from_numpy(a)), tfmt.FP32.decode(torch.from_numpy(b))))


@pytest.mark.parametrize("round_mode", ["trunc", "rne"])
@pytest.mark.parametrize("lsb", [-30, -12, 3])
def test_product_limbs_bit_equal(round_mode, lsb):
    js, ts = _specs(4, 40, lsb, round_mode)
    (ja, jb), (ta, tb) = _decoded_operands((64, 9), (64, 9), seed=lsb + 100)
    want = np.asarray(jacc.product_limbs(js, ja, jb))
    got = tacc.product_limbs(ts, ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("round_mode", ["trunc", "rne"])
def test_product_limb_block_sum_and_carry_normalize_bit_equal(round_mode):
    js, ts = _specs(30, 30, -30, round_mode)
    (ja, jb), (ta, tb) = _decoded_operands((40, 6, 1), (40, 1, 5), seed=7)
    want = np.asarray(jacc.product_limb_block_sum(js, ja, jb, axis=0))
    got = tacc.product_limb_block_sum(ts, ta, tb, axis=0)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(np.asarray(jacc.carry_normalize(js, jnp.asarray(want))),
                                  tacc.carry_normalize(ts, got).numpy())


def test_carry_normalize_wraps_top_limb_like_int32():
    js, ts = _specs(30, 30, -30)
    rng = np.random.default_rng(3)
    limbs = rng.integers(-2 ** 30, 2 ** 30, (50, js.num_limbs)).astype(np.int32)
    limbs[:, -1] = rng.integers(2 ** 31 - 4, 2 ** 31, 50).astype(np.int32)
    want = np.asarray(jacc.carry_normalize(js, jnp.asarray(limbs)))
    got = tacc.carry_normalize(ts, torch.from_numpy(limbs)).numpy()
    np.testing.assert_array_equal(want, got)


def _oracle(a, b, spec):
    """The Fraction oracle in every round and overflow mode: per-product
    quantization at 2^lsb (trunc toward zero, or RNE on the magnitude),
    exact sum, W-bit wrap or saturation, one RNE to f32. trunc/wrap is
    conftest's ``fdp_oracle``."""
    if spec.round_mode == "trunc" and spec.overflow_mode == "wrap":
        return fdp_oracle(a, b, spec)
    scale = Fraction(2) ** spec.lsb
    exact = 0
    for x, y in zip(np.asarray(a, np.float64).tolist(), np.asarray(b, np.float64).tolist()):
        p = Fraction(x) * Fraction(y)
        mag = abs(p) / scale
        q = int(mag)
        if spec.round_mode == "rne":
            rem = mag - q
            if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and q % 2 == 1):
                q += 1
        exact += q if p >= 0 else -q
    W = spec.width
    if spec.overflow_mode == "wrap":
        exact = ((exact + 2 ** (W - 1)) % 2 ** W) - 2 ** (W - 1)
    else:
        exact = min(max(exact, -2 ** (W - 1)), 2 ** (W - 1) - 1)
    return frac_to_f32_rne(Fraction(exact) * scale)


@pytest.mark.parametrize("round_mode,overflow_mode", ROUND_OVERFLOW)
@pytest.mark.parametrize("spec_args,scale", [((30, 30, -30), 1.0),
                                             ((2, 6, -14), 6.0),
                                             ((9, 6, -20), 0.5)])
def test_to_float_matches_fraction_oracle(spec_args, scale, round_mode, overflow_mode):
    _, spec = _specs(*spec_args, round_mode, overflow_mode)
    rng = np.random.default_rng(zlib.crc32(repr((spec_args, round_mode, overflow_mode)).encode()))
    for _ in range(6):
        K = int(rng.integers(3, 120))
        a = (rng.standard_normal(K) * scale).astype(np.float32)
        b = (rng.standard_normal(K) * scale).astype(np.float32)
        got = tfdp.fdp_dot(torch.from_numpy(a), torch.from_numpy(b), spec).item()
        assert np.float32(got) == _oracle(a, b, spec)


def test_saturation_pins_the_register_at_its_extremes():
    _, spec = _specs(1, 4, -8, overflow_mode="saturate")
    a = torch.full((50,), 4.0)
    hi = tfdp.fdp_dot(a, a, spec).item()
    lo = tfdp.fdp_dot(a, -a, spec).item()
    assert hi == (2 ** (spec.width - 1) - 1) * 2.0 ** spec.lsb
    assert lo == -(2 ** (spec.width - 1)) * 2.0 ** spec.lsb


def test_merge_states_is_order_free():
    _, spec = _specs(30, 30, -30)
    rng = np.random.default_rng(9)
    a = torch.from_numpy((rng.standard_normal((6, 300)) * 3).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((300, 4)) * 3).astype(np.float32))
    whole = tfdp.fdp_gemm_limbs(a, b, spec)
    parts = torch.stack([tfdp.fdp_gemm_limbs(a[:, k:k + 70], b[k:k + 70], spec)
                         for k in range(0, 300, 70)])
    torch.testing.assert_close(tacc.merge_states(spec, parts), whole, rtol=0, atol=0)
    torch.testing.assert_close(tacc.merge_states(spec, parts.flip(0)), whole, rtol=0, atol=0)


def test_wide_significands_are_refused():
    """posit32_2 carries 28-bit significands; the datapath's exact product
    holds 24x24 bits (the reference overflows its int32 digits there)."""
    x = tfmt.POSIT32_2.from_float(torch.ones(4))
    with pytest.raises(ValueError, match="significands"):
        tfdp.fdp_dot(x, x, tacc.AccumulatorSpec.paper_91bit(), tfmt.POSIT32_2)
