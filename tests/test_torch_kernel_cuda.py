"""The FDP GEMM kernel against its plain PyTorch version on a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402

SPEC_ARGS = {
    "paper_91bit": dict(ovf=30, msb=30, lsb=-30),
    "rne": dict(ovf=30, msb=30, lsb=-30, round_mode="rne"),
    "saturate": dict(ovf=2, msb=5, lsb=-18, overflow_mode="saturate"),
}


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(0)
    # the last case gives each of the kernel's 8 K-slices more than
    # SAFE_CHUNK products, so carries also normalize inside its K loop
    cases = [((3, 5, 70, 9), "ieee_fp32", "paper_91bit"),
             ((2, 17, 300, 33), "bfloat16", "rne"),
             ((2, 4, 64, 40), "posit16_1", "saturate"),
             ((4, 1, 1024, 64), "ieee_fp32", "saturate"),
             ((1, 2, 8 * tacc.SAFE_CHUNK + 4099, 16), "ieee_fp32", "paper_91bit")]
    for (B, M, K, N), fmt_name, spec_name in cases:
        tf = tfmt.get_format(fmt_name)
        ts = tacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
        a, b = torch.randn(B, M, K, generator=g), torch.randn(1, K, N, generator=g)
        if isinstance(tf, tfmt.PositFormat):
            a, b = tf.from_float(a), tf.from_float(b)
        a, b = a.cuda(), b.cuda().expand(B, K, N)
        want = tk.fdp_gemm_plain(a, b, spec=ts, fmt=tf)
        got = tk.fdp_gemm(a, b, spec=ts, fmt=tf)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (B, M, K, N, fmt_name, spec_name)

