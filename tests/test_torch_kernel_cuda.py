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



@pytest.mark.cuda
def test_ragged_kernel_bit_equal_to_plain_on_card():
    """The sorted-segment kernel against its plain version: zero-size groups
    (leading and trailing), rows past the total, a strided weight view, and
    every format; then the MoE block under the kernel policy reads nothing
    on the host (``set_sync_debug_mode("error")`` raises on any sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as TD
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import moe as TM

    g = torch.Generator().manual_seed(1)
    cases = [(50, 70, 40, [0, 9, 0, 14, 7, 0], "ieee_fp32", "paper_91bit"),
             (24, 33, 9, [0, 0, 24], "bfloat16", "rne"),
             (16, 64, 40, [5, 0, 11, 0], "posit16_1", "saturate")]
    for T, d, f, gs, fmt_name, spec_name in cases:
        tf = tfmt.get_format(fmt_name)
        ts = tacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
        x, w = torch.randn(T, d, generator=g), torch.randn(len(gs), d, 2 * f, generator=g)
        if isinstance(tf, tfmt.PositFormat):
            x, w = tf.from_float(x), tf.from_float(w)
        x, w = x.cuda(), w.cuda()[:, :, ::2]             # a strided view
        sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
        want = tk.fdp_ragged_gemm_plain(x, w, sizes, spec=ts, fmt=tf)
        got = tk.fdp_ragged_gemm(x, w, sizes, spec=ts, fmt=tf)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (T, d, f, gs, fmt_name, spec_name)
        assert not got[sum(gs):].any()

    cfg = get_config("dbrx-132b").reduced()
    block = TM.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, torch.Generator("cuda").manual_seed(0),
                   device="cuda")
    x = torch.randn(2, 3, cfg.d_model, device="cuda")
    launches = tk.fdp_ragged_gemm.launches
    with TD.use_policy(FDP91_KERNEL):
        TM.moe_block(x, block, cfg)                      # warm-up: builds the kernels
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = TM.moe_block(x, block, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert tk.fdp_ragged_gemm.launches == launches + 6


@pytest.mark.cuda
def test_ragged_dw_kernel_bit_equal_to_plain_on_card():
    """The sorted-segment weight-gradient kernel against its plain version:
    zero-size groups leading, inner and trailing, every group empty, rows
    past the total, strided (transposed) operands, a group longer than
    SAFE_CHUNK rows, and every format."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(2)
    cases = [(50, 13, 40, [0, 9, 0, 14, 7, 0], "ieee_fp32", "paper_91bit"),
             (24, 33, 9, [0, 0, 24], "bfloat16", "rne"),
             (16, 20, 40, [5, 0, 11, 0], "posit16_1", "saturate"),
             (8, 6, 8, [0, 0, 0], "ieee_fp32", "paper_91bit"),
             (tacc.SAFE_CHUNK + 517, 3, 33, [0, tacc.SAFE_CHUNK + 500], "ieee_fp32",
              "paper_91bit")]
    for T, d, f, gs, fmt_name, spec_name in cases:
        tf = tfmt.get_format(fmt_name)
        ts = tacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
        x, go = torch.randn(d, T, generator=g), torch.randn(T, 2 * f, generator=g)
        if T > tacc.SAFE_CHUNK:
            x, go = x.abs(), go.abs()                    # limbs grow: carries must normalize
        if isinstance(tf, tfmt.PositFormat):
            x, go = tf.from_float(x), tf.from_float(go)
        x, go = x.cuda().T, go.cuda()[:, ::2]            # strided views
        sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
        want = tk.fdp_ragged_dw_plain(x, go, sizes, spec=ts, fmt=tf)
        got = tk.fdp_ragged_dw(x, go, sizes, spec=ts, fmt=tf)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (T, d, f, gs, fmt_name, spec_name)
        for e, n in enumerate(gs):
            assert n or not got[e].any()


@pytest.mark.cuda
def test_backward_on_the_card_uses_the_forward_policy():
    """A loss and backward of the reduced MoE model whose forward ran under
    the FDP kernel policy: every backward site launches a kernel although
    torch runs the backward on its device thread, where use_policy is not
    installed; the MoE block's backward reads nothing on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as TD
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import init, moe as TM
    from repro_torch.train.loop import make_loss_fn

    cfg = get_config("dbrx-132b").reduced()
    params = init(cfg, seed=0, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), device="cuda"),
             "targets": torch.randint(0, cfg.vocab_size, (2, 8), device="cuda")}
    loss_fn = make_loss_fn(cfg, remat="block")
    counters = (tk.fdp_gemm, tk.fdp_ragged_gemm, tk.fdp_ragged_dw)
    before = [c.launches for c in counters]
    TD.reset_sites_seen()
    with TD.use_policy(FDP91_KERNEL):
        loss, _ = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    torch.cuda.synchronize()
    calls = TD.site_calls()
    TD.reset_sites_seen()
    launched = [c.launches - b for c, b in zip(counters, before)]
    ragged = {s for s in calls if s.split("@")[0] in ("moe_in", "moe_gate", "moe_out")}
    assert launched[2] == sum(calls[s] for s in ragged if s.endswith("@bwd.dB")) > 0
    assert launched[1] == sum(calls[s] for s in ragged if not s.endswith("@bwd.dB")) > 0
    assert launched[0] == sum(n for s, n in calls.items() if s not in ragged) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    x = torch.randn(2, 3, cfg.d_model, device="cuda", requires_grad=True)
    block = params.layers[0].moe
    with TD.use_policy(FDP91_KERNEL):
        out = TM.moe_block(x, block, cfg)
    gout = torch.randn_like(out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gx, = torch.autograd.grad(out, x, gout)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert gx.shape == x.shape and bool(torch.isfinite(gx).all())


@pytest.mark.cuda
def test_looped_kernel_bit_equal_to_plain_on_card():
    """The seed-order kernel (``ops.fdp_gemm(impl="loop")``) against its
    plain version and the vector kernel: every format, rne and saturate,
    ragged and strided operands, K past the plan's bk and past SAFE_CHUNK,
    several tiles (one wider than a block's 1024 threads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.core.dispatch import GemmPlan
    from repro_torch.kernels import ops as tops

    g = torch.Generator().manual_seed(3)
    cases = [((5, 70, 9), "ieee_fp32", "paper_91bit", (32, 32, 128)),
             ((17, 300, 33), "bfloat16", "rne", (8, 16, 64)),
             ((4, 64, 40), "posit16_1", "saturate", (32, 32, 128)),
             ((40, 1000, 24), "ieee_fp32", "paper_91bit", (64, 64, 256)),
             ((3, tacc.SAFE_CHUNK + 700, 16), "ieee_fp32", "paper_91bit", (8, 8, 1 << 20))]
    before = tk.fdp_gemm_looped.launches
    for (M, K, N), fmt_name, spec_name, tile in cases:
        tf = tfmt.get_format(fmt_name)
        ts = tacc.AccumulatorSpec(**SPEC_ARGS[spec_name])
        a, b = torch.randn(K, M, generator=g), torch.randn(K, 2 * N, generator=g)
        if K > tacc.SAFE_CHUNK:
            a, b = a.abs(), b.abs()                      # limbs grow: carries must normalize
        if isinstance(tf, tfmt.PositFormat):
            a, b = tf.from_float(a), tf.from_float(b)
        a, b = a.cuda().T, b.cuda()[:, ::2]              # strided views
        plan = GemmPlan(*tile)
        want = tk.fdp_gemm_plain(a[None], b[None], spec=ts, fmt=tf)[0]
        got = tops.fdp_gemm(a, b, spec=ts, fmt=tf, plan=plan, impl="loop")
        vec = tops.fdp_gemm(a, b, spec=ts, fmt=tf, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (M, K, N, fmt_name, spec_name, tile)
        assert torch.equal(vec, got), (M, K, N, fmt_name, spec_name, tile)
    assert tk.fdp_gemm_looped.launches == before + len(cases)


@pytest.mark.cuda
def test_looped_wrapper_raises_on_a_failed_launch(monkeypatch):
    """The C entry point refuses an unfitted carry cadence with a non-zero
    cudaError, and the wrapper raises on a non-zero code instead of falling
    back to the plain version, and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.core.dispatch import GemmPlan

    spec = tacc.AccumulatorSpec(30, 30, -30)
    a = torch.randn(4, 8, device="cuda")
    b = torch.randn(8, 4, device="cuda")
    out = torch.empty(4, 4, device="cuda")
    lib = tk.load()["fdp_gemm_looped"]
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fdp_gemm_looped_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), 4, 4, 8,
                                     8, 8, 0, *a.stride(), *b.stride(),
                                     *tk._numerics_args(spec, tfmt.FP32), stream)
    assert err != 0                                      # bk = 0 is refused

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1                       # cudaErrorInvalidValue

    monkeypatch.setattr(tk, "load", lambda: {"fdp_gemm_looped": Refusing()})
    before = tk.fdp_gemm_looped.launches
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tk.fdp_gemm_looped(a, b, GemmPlan(8, 8, 8), spec=spec, fmt=tfmt.FP32)
    assert tk.fdp_gemm_looped.launches == before
