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
    # the last case runs K past 8 x SAFE_CHUNK, the carry cadence of the
    # limb registers (the dense kernel's word register carries at every
    # product; test_dense_kernel_registers_tiles_and_strides_on_card holds
    # one register to more than SAFE_CHUNK positive products)
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



def _ragged_case(g, T, d, f, gs, tf, *, scale=1.0, wt=False):
    """x (T, d) and w (E, d, f) on the card: w a strided view of every other
    column, or with wt the transposed view of an (E, f, d) weight (the dX
    call). Float inputs are not rounded to the format: the kernel and the
    plain version decode IEEE formats from their f32 bits, so full f32
    significands reach the register and RNE rounds nearly every product."""
    x = torch.randn(T, d, generator=g) * scale
    w = torch.randn(len(gs), f, d, generator=g) if wt else torch.randn(len(gs), d, 2 * f,
                                                                        generator=g)
    if isinstance(tf, tfmt.PositFormat):
        x, w = tf.from_float(x), tf.from_float(w)
    x, w = x.cuda(), w.cuda()
    w = w.transpose(-1, -2) if wt else w[:, :, ::2]
    return x, w, torch.tensor(gs, dtype=torch.int32, device="cuda")


@pytest.mark.cuda
def test_ragged_kernel_bit_equal_to_plain_on_card():
    """The sorted-segment kernel against its plain version: zero-size groups
    (leading and trailing), rows past the total, groups longer than a row
    tile with partial last tiles, 1- and 2-row groups (one-row tiles), a
    strided and a transposed weight view, register capacities 2, 4, 6, 12
    and 32, a saturating narrow register fed products past its top limb,
    RNE at a scale where every product rounds, and every format; the
    one-row tiles (T = E, run by ``fdp::row_chunks``) in posit, with RNE
    rounding and with the saturating narrow register too. Rows past the
    total read 0.0 though ``torch.empty`` gave the output. Then the MoE
    block under the kernel policy reads nothing on the host
    (``set_sync_debug_mode("error")`` raises on any sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as TD
    from repro_torch.launch.serve import FDP91_KERNEL
    from repro_torch.models import moe as TM

    g = torch.Generator().manual_seed(1)
    spec = tacc.AccumulatorSpec
    fp32, bf16 = tfmt.get_format("ieee_fp32"), tfmt.get_format("bfloat16")
    posit = tfmt.get_format("posit16_1")
    p91, rne = spec(30, 30, -30), spec(30, 30, -30, round_mode="rne")
    cases = [
        ((50, 70, 40, [0, 9, 0, 14, 7, 0]), fp32, p91, {}),
        ((24, 33, 9, [0, 0, 24]), bf16, rne, {}),
        ((16, 64, 40, [5, 0, 11, 0]), posit, spec(2, 5, -18, overflow_mode="saturate"), {}),
        ((150, 200, 72, [70, 0, 45, 35]), fp32, p91, {}),                 # partial tiles
        ((16, 300, 100, [1, 2, 0, 1, 2, 2, 0, 1, 1, 2, 0, 1, 2, 1, 0, 0]), fp32, p91, {}),
        ((96, 160, 72, [30, 0, 50, 16]), fp32, p91, dict(wt=True)),      # the dX view
        ((40, 100, 37, [0, 17, 23]), fp32, spec(2, 5, -8), dict(scale=8.0)),      # 1 limb
        ((64, 150, 45, [20, 0, 44]), fp32, spec(9, 6, -20), {}),                 # 3 limbs
        ((40, 200, 40, [15, 0, 25]), fp32, spec(9, 6, -20, overflow_mode="saturate"),
         dict(scale=3e6)),
        ((24, 90, 19, [9, 0, 15]), bf16, spec(60, 60, -60), dict(scale=1e10)),  # 12 limbs
        ((24, 170, 29, [0, 11, 13]), fp32, spec(100, 200, -100, round_mode="rne"),
         dict(scale=1e20)),                                                      # 26 limbs
        ((32, 120, 40, [0, 12, 20]), fp32, rne, dict(scale=1e-6)),   # every product rounds
    ]
    one_row = [                                                      # T = E: one-row tiles
        ((16, 200, 70, [1, 2, 0, 1, 2, 1, 1, 0, 2, 1, 1, 0, 2, 1, 1, 0]), posit,
         spec(2, 5, -18, overflow_mode="saturate"), {}),
        ((16, 240, 70, [2, 1, 1, 0, 1, 2, 0, 1, 1, 2, 1, 1, 0, 2, 1, 0]), fp32, rne,
         dict(scale=1e-6)),
        ((16, 200, 40, [0, 1, 2, 1, 1, 0, 2, 2, 1, 1, 0, 1, 2, 1, 1, 0]), fp32,
         spec(9, 6, -20, overflow_mode="saturate"), dict(scale=3e6)),  # every product past
        ((16, 200, 40, [1, 1, 0, 2, 1, 1, 2, 0, 1, 1, 2, 1, 0, 1, 2, 0]), fp32,
         spec(9, 6, -20, overflow_mode="saturate"), dict(scale=4e3)),  # about half the sums
    ]
    for (T, d, f, gs), _, ts, _ in one_row:
        assert tk.ragged_launch(ts.num_limbs, T, len(gs), d, f, 132).tile[0] == 1
    capacities = set()
    for (T, d, f, gs), tf, ts, kw in cases + one_row:
        x, w, sizes = _ragged_case(g, T, d, f, gs, tf, **kw)
        want = tk.fdp_ragged_gemm_plain(x, w, sizes, spec=ts, fmt=tf)
        torch.cuda.empty_cache()
        torch.full((T, f), float("nan"), device="cuda")  # what torch.empty may hand back
        got = tk.fdp_ragged_gemm(x, w, sizes, spec=ts, fmt=tf)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (T, d, f, gs, tf.name, ts.describe(), kw)
        assert not got[sum(gs):].any()
        capacities.add(tk.ragged_launch(ts.num_limbs, T, len(gs), d, f, 132).lc)
    assert {2, 4, 6, 12, 32} <= capacities

    cfg = get_config("dbrx-132b").reduced()
    # weights are drawn on the host from a CPU generator, whatever the device
    block = TM.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, torch.Generator().manual_seed(0),
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


def _ragged_launch_args(lib_calls: list):
    """A stand-in for ``fdp_gemm.load`` whose sorted-segment entry point
    records each call's layout (lc, tm, tx, ty, ks, bks) and launches the
    real kernel."""
    lib = tk.load()["fdp_ragged_gemm"]

    class Recording:
        def fdp_ragged_gemm_launch(self, *args):
            lib_calls.append(args[-7:-1])
            return lib.fdp_ragged_gemm_launch(*args)

    return lambda: {"fdp_ragged_gemm": Recording()}


@pytest.mark.cuda
def test_ragged_kernel_every_layout_on_card():
    """Every layout ``dense_layouts`` offers for a decode shape (16 rows in
    16 groups: one-row tiles) and a prefill shape (256 rows in 16 groups),
    launched through the C entry point, gives the plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(5)
    fp32 = tfmt.get_format("ieee_fp32")
    ts = tacc.AccumulatorSpec(30, 30, -30)
    lib = tk.load()["fdp_ragged_gemm"]
    stream = torch.cuda.current_stream().cuda_stream
    numerics = tk._numerics_args(ts, fp32)
    for T, d, f, gs in ((16, 256, 96, [2, 0, 1, 1, 2, 0, 1, 1, 1, 2, 0, 1, 1, 1, 1, 1]),
                        (256, 256, 96, [9, 30, 0, 17, 12, 25, 3, 20, 16, 11, 14, 22, 0,
                                        31, 26, 20])):
        x, w, sizes = _ragged_case(g, T, d, f, gs, fp32)
        want = tk.fdp_ragged_gemm_plain(x, w, sizes, spec=ts, fmt=fp32)
        lays = list(tk.dense_layouts(ts.num_limbs, -(-T // len(gs)), f, d))
        assert tk.ragged_launch(ts.num_limbs, T, len(gs), d, f, 132) in lays
        for lay in lays:
            out = torch.full((T, f), float("nan"), device="cuda")
            err = lib.fdp_ragged_gemm_launch(
                x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(), T, len(gs), d,
                f, *x.stride(), *w.stride(), *numerics, lay.lc, lay.tm, lay.tx, lay.ty,
                lay.ks, lay.bks, stream)
            torch.cuda.synchronize()
            assert err == 0 and torch.equal(out, want), (T, lay)


@pytest.mark.cuda
def test_ragged_layout_ignores_the_group_sizes_on_card(monkeypatch):
    """Two routings of one shape (all rows in one group; one row a group,
    some groups empty, the total short of T) launch with the same layout,
    and both give the plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(6)
    fp32 = tfmt.get_format("ieee_fp32")
    ts = tacc.AccumulatorSpec(30, 30, -30)
    calls = []
    monkeypatch.setattr(tk, "load", _ragged_launch_args(calls))
    for gs in ([0, 0, 40, 0, 0, 0, 0, 0], [1, 1, 0, 1, 1, 0, 1, 1]):
        x, w, sizes = _ragged_case(g, 40, 64, 48, gs, fp32)
        got = tk.fdp_ragged_gemm(x, w, sizes, spec=ts, fmt=fp32)
        assert torch.equal(got, tk.fdp_ragged_gemm_plain(x, w, sizes, spec=ts, fmt=fp32)), gs
    assert len(calls) == 2 and calls[0] == calls[1]


@pytest.mark.cuda
def test_ragged_wrapper_raises_on_a_failed_launch(monkeypatch):
    """The C entry point refuses a thread layout that is not 256 threads, a
    capacity below the spec's limbs or not in its table, and a thread tile
    of rows its capacity lacks; the wrapper raises on a non-zero code
    instead of falling back to the plain version, and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = tacc.AccumulatorSpec(30, 30, -30)
    x = torch.randn(4, 8, device="cuda")
    w = torch.randn(2, 8, 4, device="cuda")
    sizes = torch.tensor([1, 3], dtype=torch.int32, device="cuda")
    out = torch.empty(4, 4, device="cuda")
    lib = tk.load()["fdp_ragged_gemm"]
    stream = torch.cuda.current_stream().cuda_stream
    numerics = tk._numerics_args(spec, tfmt.FP32)
    for lc, tm, tx, ty, ks, bks in ((6, 4, 16, 1, 8, 1), (4, 4, 2, 1, 128, 1),
                                    (7, 4, 2, 1, 128, 1), (6, 8, 2, 1, 128, 1),
                                    (6, 3, 2, 1, 128, 1), (24, 2, 2, 1, 128, 1)):
        err = lib.fdp_ragged_gemm_launch(x.data_ptr(), w.data_ptr(), sizes.data_ptr(),
                                         out.data_ptr(), 4, 2, 8, 4, *x.stride(), *w.stride(),
                                         *numerics, lc, tm, tx, ty, ks, bks, stream)
        assert err != 0, (lc, tm, tx, ty, ks, bks)

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1                       # cudaErrorInvalidValue

    monkeypatch.setattr(tk, "load", lambda: {"fdp_ragged_gemm": Refusing()})
    before = tk.fdp_ragged_gemm.launches
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tk.fdp_ragged_gemm(x, w, sizes, spec=spec, fmt=tfmt.FP32)
    assert tk.fdp_ragged_gemm.launches == before


def _dw_case(g, T, d, f, gs, tf, *, scale=1.0, positive=False, views=True):
    """x (T, d) and g (T, f) on the card: with views, x the transposed view
    of a (d, T) tensor and g every other column of a (T, 2f) one (they load
    along t and with a stride), else contiguous (as the training step calls
    it: loads along d and f). Float inputs are not rounded to the format
    (so RNE rounds nearly every product)."""
    x = (torch.randn(d, T, generator=g).T if views else torch.randn(T, d, generator=g)) * scale
    go = torch.randn(T, 2 * f, generator=g) if views else torch.randn(T, f, generator=g)
    if positive:
        x, go = x.abs(), go.abs()
    if isinstance(tf, tfmt.PositFormat):
        x, go = tf.from_float(x), tf.from_float(go)
    if views:
        x, go = x.T.cuda().T, go.cuda()[:, ::2]
    else:
        x, go = x.cuda(), go.cuda()
    return x, go, torch.tensor(gs, dtype=torch.int32, device="cuda")


@pytest.mark.cuda
def test_ragged_dw_kernel_bit_equal_to_plain_on_card():
    """The sorted-segment weight-gradient kernel against its plain version:
    zero-size groups leading, inner and trailing, every group empty, rows
    past the total, strided (transposed) and contiguous operands, a group
    longer than SAFE_CHUNK rows, every format; groups of 1, 31, 33 and 65
    rows (no multiple of a chunk: the last chunk's k loop stops at the
    group's end); register capacities 2, 4, 6, 12 and 32, RNE where every
    product rounds, and a saturating 3-limb register fed products past its
    top limb. Each case runs through the wrapper and again through the C
    entry point at the wrapper's layout into a NaN-filled output, so every
    output must be written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(2)
    spec = tacc.AccumulatorSpec
    fp32, bf16 = tfmt.get_format("ieee_fp32"), tfmt.get_format("bfloat16")
    posit = tfmt.get_format("posit16_1")
    p91, rne = spec(30, 30, -30), spec(30, 30, -30, round_mode="rne")
    sat = spec(2, 5, -18, overflow_mode="saturate")
    cases = [((50, 13, 40, [0, 9, 0, 14, 7, 0]), fp32, p91, {}),
             ((24, 33, 9, [0, 0, 24]), bf16, rne, {}),
             ((16, 20, 40, [5, 0, 11, 0]), posit, sat, {}),
             ((8, 6, 8, [0, 0, 0]), fp32, p91, {}),
             ((tacc.SAFE_CHUNK + 517, 3, 33, [0, tacc.SAFE_CHUNK + 500]), fp32, p91,
              dict(positive=True)),                            # one register, all positive
             ((140, 70, 90, [1, 31, 0, 33, 65]), fp32, p91, {}),            # short chunks
             ((140, 70, 90, [65, 33, 1, 0, 31]), fp32, p91, dict(views=False)),
             ((140, 96, 80, [33, 0, 1, 65, 31]), posit, sat, dict(views=False)),
             ((60, 100, 37, [0, 17, 33]), fp32, spec(2, 5, -8), dict(scale=8.0)),  # 1 limb
             ((80, 150, 45, [31, 0, 44]), fp32, spec(9, 6, -20), dict(views=False)),  # 3 limbs
             ((70, 200, 40, [33, 0, 31]), fp32, spec(9, 6, -20, overflow_mode="saturate"),
              dict(scale=3e6)),                                # every product past the top
             ((40, 90, 19, [9, 0, 31]), bf16, spec(60, 60, -60), dict(scale=1e10)),  # 12 limbs
             ((40, 170, 29, [0, 1, 33]), fp32, spec(100, 200, -100, round_mode="rne"),
              dict(scale=1e20)),                               # 26 limbs
             ((72, 120, 40, [0, 31, 33]), fp32, rne, dict(scale=1e-6)),  # every product rounds
             ]
    capacities, sms = set(), tk._sm_count(torch.cuda.current_device())
    for (T, d, f, gs), tf, ts, kw in cases:
        x, go, sizes = _dw_case(g, T, d, f, gs, tf, **kw)
        want = tk.fdp_ragged_dw_plain(x, go, sizes, spec=ts, fmt=tf)
        got = tk.fdp_ragged_dw(x, go, sizes, spec=ts, fmt=tf)
        lay = tk.ragged_dw_launch(ts.num_limbs, T, len(gs), d, f, sms)
        out = torch.full((len(gs), d, f), float("nan"), device="cuda")
        err = _dw_entry(x, go, sizes, out, ts, tf, lay)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (T, d, f, gs, tf.name, ts.describe(), kw)
        assert err == 0 and torch.equal(want, out), (T, d, f, gs, tf.name, ts.describe(), kw)
        for e, n in enumerate(gs):
            assert n or not got[e].any()
        if ts.overflow_mode == "saturate" and kw.get("scale", 1.0) > 1e3:
            # the register's extremes, rounded to f32 as the read-out does
            hi = float(torch.tensor((2 ** (ts.width - 1) - 1) * 2.0 ** ts.lsb).float())
            lo = -(2 ** (ts.width - 1)) * 2.0 ** ts.lsb
            assert bool(((got == hi) | (got == lo)).any()), "the saturate case never saturated"
        capacities.add(lay.lc)
    assert {2, 4, 6, 12, 32} <= capacities


def _dw_entry(x, go, sizes, out, ts, tf, lay):
    """One launch of the weight-gradient kernel's C entry point at layout
    ``lay``; its cudaError."""
    lib = tk.load()["fdp_ragged_dw"]
    T, d = x.shape
    return lib.fdp_ragged_dw_launch(
        x.data_ptr(), go.data_ptr(), sizes.data_ptr(), out.data_ptr(), T, sizes.shape[0], d,
        go.shape[1], *x.stride(), *go.stride(), *tk._numerics_args(ts, tf), lay.lc, lay.tm,
        lay.tx, lay.ty, lay.ks, lay.bks, torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
def test_ragged_dw_kernel_every_layout_on_card():
    """Every layout ``dense_layouts`` offers for a small training-like
    weight gradient (512 rows in 8 groups of 0 to 95, d 128, f 96),
    launched through the C entry point on contiguous and on strided views,
    writes every output with the plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(7)
    fp32 = tfmt.get_format("ieee_fp32")
    ts = tacc.AccumulatorSpec(30, 30, -30)
    T, d, f, gs = 512, 128, 96, [65, 95, 0, 33, 1, 64, 91, 63]
    lays = list(tk.dense_layouts(ts.num_limbs, d, f, -(-T // len(gs))))
    assert tk.ragged_dw_launch(ts.num_limbs, T, len(gs), d, f, 132) in lays
    for views in (False, True):
        x, go, sizes = _dw_case(g, T, d, f, gs, fp32, views=views)
        want = tk.fdp_ragged_dw_plain(x, go, sizes, spec=ts, fmt=fp32)
        for lay in lays:
            out = torch.full((len(gs), d, f), float("nan"), device="cuda")
            err = _dw_entry(x, go, sizes, out, ts, fp32, lay)
            torch.cuda.synchronize()
            assert err == 0 and torch.equal(out, want), (views, lay)


@pytest.mark.cuda
def test_ragged_dw_layout_ignores_the_group_sizes_on_card(monkeypatch):
    """Two routings of one shape (every row in one group; short groups,
    some empty, the total short of T) launch with the same layout, and both
    give the plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(8)
    fp32 = tfmt.get_format("ieee_fp32")
    ts = tacc.AccumulatorSpec(30, 30, -30)
    lib = tk.load()["fdp_ragged_dw"]
    calls = []

    class Recording:
        def fdp_ragged_dw_launch(self, *args):
            calls.append(args[-7:-1])
            return lib.fdp_ragged_dw_launch(*args)

    monkeypatch.setattr(tk, "load", lambda: {"fdp_ragged_dw": Recording()})
    for gs in ([0, 0, 200, 0, 0, 0, 0, 0], [31, 1, 0, 33, 65, 0, 1, 2]):
        x, go, sizes = _dw_case(g, 200, 64, 48, gs, fp32, views=False)
        got = tk.fdp_ragged_dw(x, go, sizes, spec=ts, fmt=fp32)
        assert torch.equal(got, tk.fdp_ragged_dw_plain(x, go, sizes, spec=ts, fmt=fp32)), gs
    assert len(calls) == 2 and calls[0] == calls[1]


@pytest.mark.cuda
def test_ragged_dw_wrapper_raises_on_a_failed_launch(monkeypatch):
    """The C entry point refuses a thread layout that is not 256 threads, a
    capacity below the spec's limbs or not in its table, a thread tile of
    rows its capacity lacks, and no groups; the wrapper raises on a non-zero
    code instead of falling back to the plain version, and counts no
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = tacc.AccumulatorSpec(30, 30, -30)
    x = torch.randn(4, 8, device="cuda")
    go = torch.randn(4, 4, device="cuda")
    sizes = torch.tensor([1, 3], dtype=torch.int32, device="cuda")
    out = torch.empty(2, 8, 4, device="cuda")
    for lc, tm, tx, ty, ks, bks in ((6, 4, 16, 1, 8, 1), (4, 4, 2, 1, 128, 1),
                                    (7, 4, 2, 1, 128, 1), (6, 8, 2, 1, 128, 1),
                                    (6, 3, 2, 1, 128, 1), (24, 2, 2, 1, 128, 1)):
        lay = tk.DenseLaunch(lc, tm, 2, tx, ty, ks, bks)
        assert _dw_entry(x, go, sizes, out, spec, tfmt.FP32, lay) != 0, lay
    lay = tk.ragged_dw_launch(6, 4, 2, 8, 4, 132)
    assert _dw_entry(x, go, sizes[:0], out, spec, tfmt.FP32, lay) != 0      # E = 0

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1                       # cudaErrorInvalidValue

    monkeypatch.setattr(tk, "load", lambda: {"fdp_ragged_dw": Refusing()})
    before = tk.fdp_ragged_dw.launches
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tk.fdp_ragged_dw(x, go, sizes, spec=spec, fmt=tfmt.FP32)
    assert tk.fdp_ragged_dw.launches == before


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


def _dense_case(g, B, M, K, N, tf, ts, *, bcast=False, ta=False, tb=False, scale=1.0,
                positive=False):
    a = torch.randn(B, M, K, generator=g) * scale
    b = torch.randn(1 if bcast else B, K, N, generator=g)
    if positive:
        a, b = a.abs(), b.abs()
    if isinstance(tf, tfmt.PositFormat):
        a, b = tf.from_float(a), tf.from_float(b)
    else:
        a, b = tf.quantize(a), tf.quantize(b)
    a, b = a.cuda(), b.cuda()
    if ta:                                               # transposed views
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    if tb:
        b = b.transpose(1, 2).contiguous().transpose(1, 2)
    return a, (b.expand(B, K, N) if bcast else b)


@pytest.mark.cuda
def test_dense_kernel_registers_tiles_and_strides_on_card():
    """The dense kernel against its plain version at capacities 2, 4, 6, 12
    and more than 24 limbs (one output a thread), saturating registers whose
    products reach past their top limb (the window mask), thread tiles of
    1, 2 and 4 rows (calls of 1, 2 and more rows a batch element), tiles
    ragged in M, N and K, transposed operands, a weight that folds into the
    rows and one that does not, and one register fed more than SAFE_CHUNK
    positive products whatever K split the launcher picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(4)
    fp32, bf16 = tfmt.get_format("ieee_fp32"), tfmt.get_format("bfloat16")
    posit = tfmt.get_format("posit16_1")
    spec = tacc.AccumulatorSpec
    cases = [
        ((2, 9, 100, 37), fp32, spec(2, 5, -8), dict(scale=8.0)),               # 1 limb
        ((2, 9, 100, 37), fp32, spec(2, 3, -8, overflow_mode="saturate"), dict(scale=1e3)),
        ((3, 17, 150, 45), fp32, spec(9, 6, -20), dict(ta=True, tb=True)),        # 3 limbs
        ((2, 4, 200, 40), fp32, spec(9, 6, -20, overflow_mode="saturate"), dict(scale=3e6)),
        ((2, 33, 257, 65), bf16, spec(30, 30, -30, round_mode="rne"), dict(ta=True)),
        ((1, 37, 170, 29), fp32, spec(100, 200, -100, round_mode="rne"), dict(scale=1e20)),
        ((2, 5, 70, 9), posit, spec(300, 200, -130), dict(tb=True)),            # 40 limbs
        ((4, 7, 96, 33), fp32, spec(30, 30, -30), dict(bcast=True)),            # folds
        ((4, 7, 96, 33), fp32, spec(30, 30, -30), dict(bcast=True, ta=True)),   # does not
        ((3, 1, 100, 37), fp32, spec(30, 30, -30), dict(tb=True)),              # 1 row
        ((5, 2, 130, 21), fp32, spec(9, 6, -20, overflow_mode="saturate"),
         dict(scale=3e6)),                                                       # 2 rows
        ((3, 1, 90, 19), bf16, spec(60, 60, -60), dict(scale=1e10)),            # 12 limbs
        ((1, 1, 256 * tacc.SAFE_CHUNK + 37, 2), fp32, spec(30, 30, -30), dict(positive=True)),
    ]
    before = tk.fdp_gemm.launches
    for (B, M, K, N), tf, ts, kw in cases:
        a, b = _dense_case(g, B, M, K, N, tf, ts, **kw)
        want = tk.fdp_gemm_plain(a, b, spec=ts, fmt=tf)
        got = tk.fdp_gemm(a, b, spec=ts, fmt=tf)
        torch.cuda.synchronize()
        assert torch.equal(want, got), ((B, M, K, N), tf.name, ts.describe(), kw)
    assert tk.fdp_gemm.launches == before + len(cases)
    # slice 0 takes bks k of every chunk of bk, and the first of the last one
    K = 256 * tacc.SAFE_CHUNK + 37
    ts = spec(30, 30, -30)
    lay = tk.dense_launch(ts.num_limbs, 1, 1, 2, K,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    bk = lay.ks * lay.bks
    assert K // bk * lay.bks + min(lay.bks, K % bk) > tacc.SAFE_CHUNK


@pytest.mark.cuda
def test_dense_wrapper_raises_on_a_failed_launch(monkeypatch):
    """The C entry point refuses a thread layout that is not 256 threads, a
    capacity below the spec's limbs or not in its table, and a thread tile
    of rows its capacity lacks; the wrapper raises on a non-zero code
    instead of falling back to the plain version, and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = tacc.AccumulatorSpec(30, 30, -30)
    a = torch.randn(1, 4, 8, device="cuda")
    b = torch.randn(1, 8, 4, device="cuda")
    out = torch.empty(1, 4, 4, device="cuda")
    lib = tk.load()["fdp_gemm"]
    stream = torch.cuda.current_stream().cuda_stream
    numerics = tk._numerics_args(spec, tfmt.FP32)
    for lc, tm, tx, ty, ks, bks in ((6, 4, 16, 1, 8, 1), (4, 4, 2, 1, 128, 1),
                                    (7, 4, 2, 1, 128, 1), (6, 8, 2, 1, 128, 1),
                                    (6, 3, 2, 1, 128, 1), (24, 2, 2, 1, 128, 1)):
        err = lib.fdp_gemm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 4, 4, 8,
                                  *a.stride(), *b.stride(), *numerics, lc, tm, tx, ty, ks,
                                  bks, stream)
        assert err != 0, (lc, tm, tx, ty, ks, bks)

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1                       # cudaErrorInvalidValue

    monkeypatch.setattr(tk, "load", lambda: {"fdp_gemm": Refusing()})
    before = tk.fdp_gemm.launches
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tk.fdp_gemm(a, b, spec=spec, fmt=tfmt.FP32)
    assert tk.fdp_gemm.launches == before
