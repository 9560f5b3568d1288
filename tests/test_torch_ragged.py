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
bit-equal to the interpret-mode kernel, against which every case runs.

The kernel's launch is chosen on the host from the shapes alone
(``ragged_launch``), and each block finds its tile of one group's rows on
the device; the last tests hold the launcher to decode shapes and a Python
copy of the device's tile scan to the grid for many routings. While a CUDA
graph is being captured, ``simulate`` runs every group over all rows and
selects on the device: the same bits, with no host read."""

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
from repro_torch.core import fdp as TF  # noqa: E402
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


@pytest.mark.parametrize("groups", list(GROUPS))
def test_capture_order_simulate_path_equals_eager_and_jax(groups, monkeypatch):
    """While a CUDA graph is being captured, ``core.fdp.fdp_ragged_gemm``
    runs every group over all T rows and selects each row's output on the
    device (``fdp_ragged_gemm_all_rows``), reading nothing on the host. It
    is bit-equal to the eager path, which reads the group sizes, and to
    JAX's ``ragged_gemm`` in ``simulate`` mode. The capture is stood in for
    by ``capturing`` patched to True, and a host read raises."""
    T, d, f, gs = GROUPS[groups]
    x, w, _, tf = _operands(T, d, f, len(gs), "ieee_fp32", seed=11)
    jsim, tsim = _policies("simulate", "ieee_fp32", "trunc_wrap")
    with JD.use_policy(jsim):
        want = _bits(JD.ragged_gemm(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(gs, jnp.int32), site="t"))
    tx, tw, tgs = torch.from_numpy(x), torch.from_numpy(w), torch.tensor(gs, dtype=torch.int32)
    ts = tacc.AccumulatorSpec(**SPEC_ARGS["trunc_wrap"])
    eager = TF.fdp_ragged_gemm(tx, tw, tgs, ts, tf)
    all_rows = TF.fdp_ragged_gemm_all_rows(tx, tw, tgs, ts, tf)

    def no_host_read(*args, **kwargs):
        raise AssertionError("the group sizes were read on the host under capture")

    monkeypatch.setattr(TF, "capturing", lambda: True)
    monkeypatch.setattr(torch.Tensor, "tolist", no_host_read)
    with TD.use_policy(tsim):
        captured = TD.ragged_gemm(tx, tw, tgs, site="t")
    monkeypatch.undo()
    assert torch.equal(all_rows, eager) and torch.equal(captured, eager)
    np.testing.assert_array_equal(_bits(captured.numpy()), want)


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


H100_SMS = 132              # the multiprocessors of an H100 SXM


@pytest.mark.parametrize("num_limbs", [1, 3, 6, 12, 26, 40])
def test_ragged_launch_gives_decode_calls_one_row_tiles(num_limbs):
    """A decode step routes T = E rows (dbrx-132b: 4 tokens x top-4 into 16
    experts), a group or two each: the launch gives a thread and a block
    one row, whatever the register's capacity, and splits K where the
    columns alone do not fill the card. A training step (1024 rows in 16
    groups) gets the capacity's most rows a thread up to 8 limbs."""
    for T, d, f in ((16, 6144, 10752), (16, 10752, 6144), (8, 64, 40)):
        lay = tk.ragged_launch(num_limbs, T, T, d, f, H100_SMS)
        assert lay.tm == 1 and lay.tile[0] == 1 and lay.lc >= num_limbs
        assert lay == tk.dense_launch(num_limbs, T, 1, f, d, H100_SMS)
    assert tk.ragged_launch(num_limbs, 16, 16, 6144, 10752, H100_SMS).ks > 1
    train = tk.ragged_launch(num_limbs, 1024, 16, 6144, 10752, H100_SMS)
    assert train.tm == tk.DENSE_TILE[train.lc][0]
    if num_limbs <= 8:
        assert train.tm == 4 and train.ks == 1


def _row_tiles(gs, T, bm, blocks):
    """The device's tile scan (``fdp_ragged_gemm_kernel``), block by block:
    (segment, first row, end row) of each block's tile, None past the real
    tiles. Segment len(gs) is the rows past the total, up to T."""
    out = []
    for block in range(blocks):
        tile, end, found = block, 0, None
        for g in range(len(gs) + 1):
            lo = min(end, T)
            if g < len(gs):
                end += gs[g]
            hi = T if g == len(gs) else min(end, T)
            tiles = -(-(hi - lo) // bm) if hi > lo else 0
            if tile < tiles:
                found = (g, lo + tile * bm, min(lo + (tile + 1) * bm, hi))
                break
            tile -= tiles
        out.append(found)
    return out


def _routings():
    """(name, T, group sizes): the edge cases, and top-k routings drawn
    from a seed (4 of 16 experts a token, and the rows of a batch cut
    short or run over)."""
    cases = [("all rows in one group", 64, [0, 0, 64, 0]),
             ("one row a group", 16, [1] * 16),
             ("empty groups leading, inner and trailing", 40, [0, 0, 9, 0, 14, 0, 7, 0]),
             ("sum < T", 50, [7, 0, 13, 0, 3]),
             ("sum > T", 20, [9, 0, 8, 6, 5]),
             ("every group empty", 12, [0, 0, 0]),
             ("no group", 5, [])]
    rng = np.random.default_rng(17)
    for i in range(24):
        tokens, E = int(rng.integers(1, 300)), int(rng.choice([4, 8, 16, 64]))
        ids = np.stack([rng.permutation(E)[:min(4, E)] for _ in range(tokens)])
        gs = np.bincount(ids.reshape(-1), minlength=E).tolist()
        T = sum(gs) + int(rng.integers(-5, 6)) if i % 3 else sum(gs)
        cases.append((f"draw {i}", max(T, 1), gs))
    return cases


def test_ragged_launch_reads_only_shapes():
    """The launch is a function of the spec's limbs, the shapes and the
    card: ``ragged_launch`` takes no group sizes, so the host never waits
    for the router, and one layout serves every routing of a shape."""
    import inspect

    assert list(inspect.signature(tk.ragged_launch).parameters) == [
        "num_limbs", "T", "E", "d", "f", "sms"]
    lay = tk.ragged_launch(6, 1024, 16, 6144, 10752, H100_SMS)
    assert tk.ragged_grid(lay, 1024, 16, 10752) == (1024 // lay.tile[0] + 16,
                                                   -(-10752 // lay.tile[1]))


@pytest.mark.parametrize("name,T,gs", _routings(), ids=[c[0] for c in _routings()])
def test_ragged_row_tiles_fit_the_grid(name, T, gs):
    """For every routing and every block height the launcher may give
    (1 to 32 rows, and ``ragged_launch``'s own pick): the scan's tiles lie
    each inside one segment, cover every row of [0, T) exactly once (the
    rows past the total in segment E), and number no more than the grid's
    ceil(T / BM) + E row tiles; the blocks past them find no tile."""
    E = len(gs)
    total = min(T, sum(gs))
    lay = tk.ragged_launch(6, T, E, 96, 64, H100_SMS)
    for bm in sorted({1, 2, 4, 8, 16, 32, lay.tile[0]}):
        rows = -(-T // bm) + E
        if bm == lay.tile[0]:
            assert tk.ragged_grid(lay, T, E, 64)[0] == rows
        tiles = _row_tiles(gs, T, bm, rows + 3)
        real = [t for t in tiles if t is not None]
        assert tiles[len(real):] == [None] * (rows + 3 - len(real))
        assert len(real) <= rows
        covered = np.zeros(T, dtype=int)
        starts = np.cumsum([0] + gs)
        for g, r0, r1 in real:
            assert 0 < r1 - r0 <= bm
            lo, hi = (min(starts[g], T), min(starts[g + 1], T)) if g < E else (total, T)
            assert lo <= r0 < r1 <= hi
            covered[r0:r1] += 1
        assert covered.tolist() == [1] * T
