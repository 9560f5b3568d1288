"""The port's FDP GEMM entry points against the JAX reference.

On the CPU the kernel wrapper runs its plain version, which must be
bit-equal to ``repro.kernels.ops`` (Pallas in interpret mode) and to
``repro.core.fdp.fdp_gemm`` for every format, round mode and overflow mode.
The kernel itself is held against the plain version on the card in
``test_torch_kernel_cuda.py``."""

import ctypes
import re

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


def test_build_tags_every_library_with_all_of_csrc(tmp_path, monkeypatch):
    """One library per ``.cu``, built by one compiler process each; the tag
    hashes every file of ``csrc/``, so editing the shared header rebuilds
    both and an unchanged tree rebuilds nothing."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, text in (("one.cu", "// one"), ("two.cu", "// two"), ("common.cuh", "// v1")):
        (csrc / name).write_text(text)
    calls = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" >> "%s"\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi; shift\ndone\n' % calls)
    fake.chmod(0o755)
    monkeypatch.setattr(tk, "_CSRC", csrc)
    monkeypatch.setattr(tk, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tk, "_nvcc", lambda: str(fake))
    first = tk.build()
    assert sorted(first) == ["one", "two"] and all(p.exists() for p in first.values())
    assert len(calls.read_text().splitlines()) == 2
    assert tk.build() == first                              # nothing changed
    assert len(calls.read_text().splitlines()) == 2
    (csrc / "common.cuh").write_text("// v2")
    second = tk.build()
    assert set(second.values()).isdisjoint(first.values())
    assert len(calls.read_text().splitlines()) == 4


def test_fold_broadcast_folds_exactly_the_stride_zero_weights_that_view():
    """A weight broadcast over the batch folds into the rows when the
    activations' batch and rows merge as a view: (B,M,K) @ (B,K,N) becomes
    (1,B*M,K) @ (1,K,N), sharing storage with the inputs. Anything else is
    left alone."""
    w = torch.randn(64, 11)
    a = torch.randn(4, 3, 64)
    folded = tk.fold_broadcast(a, w.expand(4, 64, 11))
    assert folded is not None
    fa, fb = folded
    assert fa.shape == (1, 12, 64) and fb.shape == (1, 64, 11)
    assert fa.data_ptr() == a.data_ptr() and fb.data_ptr() == w.data_ptr()
    a[1, 2, 5] = 7.0                                    # a view, not a copy
    assert fa[0, 5, 5] == 7.0
    # a decode step, (B,1,K), folds too
    assert tk.fold_broadcast(torch.randn(4, 1, 64), w.expand(4, 64, 11))[0].shape == (1, 4, 64)
    # not folded: a weight that is not broadcast, one batch element, and
    # activations whose batch and rows do not merge without a copy
    assert tk.fold_broadcast(a, torch.randn(4, 64, 11)) is None
    assert tk.fold_broadcast(torch.randn(1, 3, 64), w[None]) is None
    strided = torch.randn(4, 64, 3).transpose(1, 2)     # (4, 3, 64), rows of stride 1
    assert tk.fold_broadcast(strided, w.expand(4, 64, 11)) is None
    gapped = torch.randn(4, 5, 64)[:, :3]               # batch stride 5*64, not 3*64
    assert tk.fold_broadcast(gapped, w.expand(4, 64, 11)) is None


@pytest.mark.parametrize("bcast_weight", [True, False])
def test_folded_call_bit_equal_to_interpret_pallas(bcast_weight):
    """The folded call computes the batched function: the plain version of
    (1,B*M,K) @ (1,K,N), viewed as (B,M,N), is bit-equal to JAX's batched
    entry point on the unfolded operands."""
    (ja, jb), (ta, tb), jf, tf = _operands((3, 5, 40), (1, 40, 7), "ieee_fp32", seed=11)
    js, ts = _spec("paper_91bit")
    jb3 = jnp.broadcast_to(jb, (3, 40, 7))
    tb3 = tb.expand(3, 40, 7) if bcast_weight else tb.expand(3, 40, 7).contiguous()
    want = jops.fdp_gemm_batched(ja, jb3, spec=js, fmt=jf)
    folded = tk.fold_broadcast(ta, tb3)
    assert (folded is not None) == bcast_weight
    fa, fb = folded if folded is not None else (ta, tb3)
    got = tk.fdp_gemm_plain(fa, fb, spec=ts, fmt=tf).view(3, 5, 7)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


# the shapes the main path gives the dense kernel (batch, rows, cols, depth)
_DENSE_SHAPES = [(1, 4, 151936, 1024), (1, 4, 3072, 1024), (1, 4, 16, 6144),
                 (1, 256, 256, 1024), (1, 64, 3072, 1024), (32, 2, 32, 128),
                 (32, 2, 128, 32), (1, 256, 100352, 6144), (1, 256, 32, 100352),
                 (1, 6144, 64, 256), (3, 5, 9, 70), (1, 1, 1, 1), (2, 17, 33, 0)]


H100_SMS = 132              # the multiprocessors of an H100 SXM


@pytest.mark.parametrize("num_limbs", range(1, tk.MAX_LIMBS + 1))
def test_dense_launch_covers_every_register_width(num_limbs):
    """For every limb count 1..40: the smallest capacity that holds it, 256
    threads in powers of two, the columns a thread owns at that capacity and
    its rows (the capacity's most, half or a quarter), a block tile no
    larger than the call rounded up to powers of two (save one thread's
    columns and one k a slice), shared memory the kernel accepts (its limit
    without opt-in: the decoded tiles, and the K split's partial
    registers), and a grid the card accepts."""
    for batch, rows, cols, depth in _DENSE_SHAPES:
        lay = tk.dense_launch(num_limbs, batch, rows, cols, depth, H100_SMS)
        assert lay.lc in tk.DENSE_CAPACITIES and lay.lc >= num_limbs
        assert all(c < num_limbs for c in tk.DENSE_CAPACITIES if c < lay.lc)
        tm_max, tn = tk.DENSE_TILE[lay.lc]
        assert lay.tn == tn and lay.words == lay.lc // 2 + 1
        assert lay.tm in (tm_max, tm_max // 2, tm_max // 4) and lay.tm >= 1
        for x in (lay.tx, lay.ty, lay.ks, lay.bks):
            assert x >= 1 and x & (x - 1) == 0
        assert lay.tx * lay.ty * lay.ks == tk.DENSE_THREADS
        assert lay.ty <= 8 and lay.bks <= 32
        bm, bn, bk = lay.tile
        assert bm <= tk._pow2_at_least(rows) and bn <= max(tn, tk._pow2_at_least(cols))
        assert lay.bks == 1 or bk <= tk._pow2_at_least(depth)
        assert (bm + bn) * bk * 8 <= tk.DENSE_SMEM_LIMIT
        red = lay.ks // 2 * lay.tx * lay.ty * lay.tm * lay.tn * lay.words * 4
        assert red <= tk.DENSE_SMEM_LIMIT
        gx, gy, gz = lay.grid(batch, rows, cols)
        assert gx * bn >= cols and gy * bm >= rows and gz == batch and gy <= 65535
    with pytest.raises(ValueError, match="1..40"):
        tk.dense_launch(tk.MAX_LIMBS + 1, 1, 4, 4, 4, H100_SMS)


def test_dense_tile_table_is_read_from_the_kernels_file():
    """The launcher's tile table is the one the kernels include
    (csrc/fdp_gemm_tiles.def): every capacity with its rows, columns and
    blocks, and the shared-memory limit. The shared tile body
    (csrc/fdp_tile.cuh) includes that file for its Tile<LC> table, its
    capacity switch and its limit; the dense kernel and both sorted-segment
    kernels (forward and weight gradient) include the tile body, and none
    reads the table or defines a tile of its own."""
    tiles, resident, limit = tk._dense_table()
    assert tiles == tk.DENSE_TILE and resident == tk.DENSE_RESIDENT
    assert tk.DENSE_CAPACITIES == (2, 4, 6, 8, 12, 16, 24, 32, 40)
    assert tiles[6] == (4, 2) and tiles[40] == (1, 1) and resident[8] == 2
    assert limit == tk.DENSE_SMEM_LIMIT == 48 * 1024
    body = (tk._CSRC / "fdp_tile.cuh").read_text()
    assert body.count('#include "fdp_gemm_tiles.def"') == 3
    assert "struct Tile<" not in body.replace("struct Tile<lc>", "").replace(
        "struct Tile;", "")
    assert sorted(p.name for p in tk._CSRC.iterdir()
                  if '#include "fdp_gemm_tiles.def"' in p.read_text()) == ["fdp_tile.cuh"]
    for kernel in ("fdp_gemm.cu", "fdp_ragged_gemm.cu", "fdp_ragged_dw.cu"):
        source = (tk._CSRC / kernel).read_text()
        assert '#include "fdp_tile.cuh"' in source and "fdp::fdp_tile<" in source
        assert "struct Tile" not in source and "load_tile(" not in source


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_entry(source: str) -> tuple:
    """(name, [ctypes type of each parameter]) of the one function in a
    source's ``extern "C"`` block: a pointer (any ``const void*`` or
    ``void*``) is ``c_void_p``, ``int`` ``c_int``, ``long long``
    ``c_longlong``."""
    block = source.split('extern "C" {', 1)[1]
    m = re.search(r"^int (\w+)\(([^)]*)\)\s*\{", block, re.M)
    types = []
    for param in " ".join(m.group(2).split()).split(", "):
        kind = param.rsplit(" ", 1)[0].replace("const ", "").replace(" *", "*")
        types.append(_C_TYPES[kind])
    return m.group(1), types


@pytest.mark.parametrize("stem", sorted(tk._ENTRIES))
def test_entry_point_signature_matches_its_ctypes_argtypes(stem):
    """Each kernel library's C entry point, parsed from its ``csrc/<stem>.cu``,
    has the name and argument types that ``_ENTRIES`` gives ctypes: a
    mismatch there is silent on the card (ctypes would pass a 64-bit stride
    as a 32-bit int, or cut a pointer). Every source has its entry."""
    assert sorted(tk._ENTRIES) == sorted(p.stem for p in tk._CSRC.glob("*.cu"))
    name, types = _c_entry((tk._CSRC / f"{stem}.cu").read_text())
    want_name, want_types = tk._ENTRIES[stem]
    assert name == want_name
    assert types == want_types


def test_entry_point_parser_reads_every_parameter_kind():
    """The signature reader of the test above, on a made-up entry point."""
    src = ('// x\nextern "C" {\n\nint f_launch(const void* a, void* b, int n,\n'
           '             long long s, void* stream) {\n  return 0;\n}\n}\n')
    assert _c_entry(src) == ("f_launch", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_void_p])


@pytest.mark.parametrize("rows", [1, 2, 3, 6, 64])
def test_dense_layouts_give_a_thread_no_more_rows_than_the_call(rows):
    """The layouts weighed for a call never give a block more rows than the
    call's, rounded up to a power of two (attention at decode: 2 rows a head
    group for qwen3-0.6b, 6 for dbrx-132b), and at every capacity they
    include a thread tile of one row; 12 limbs hold at most 2 rows a thread
    and 24 or more limbs 1."""
    for limbs, tm_max in ((6, 4), (12, 2), (26, 1)):
        lays = list(tk.dense_layouts(limbs, rows, 32, 128))
        assert {lay.tm for lay in lays} == {t for t in (1, 2, 4) if t <= tm_max
                                            and t <= tk._pow2_at_least(rows)}
        assert all(lay.tile[0] <= tk._pow2_at_least(rows) for lay in lays)
        assert tk.dense_launch(limbs, 32, rows, 32, 128, H100_SMS) in lays


def test_dense_cost_counts_waves_and_a_threads_work():
    """The cost model: a layout that needs a second wave of blocks costs
    more than one that does not with the same thread work; a deeper K
    split trades a thread's products for levels of the summing tree; a
    wider register costs more a product."""
    one = tk.DenseLaunch(6, 4, 2, 32, 8, 1, 32)
    sms = 132
    fits = tk.dense_cost(one, 1, 32, 64 * 3 * sms, 1024, sms)        # 3 blocks an SM
    spills = tk.dense_cost(one, 1, 32, 64 * 3 * sms + 1, 1024, sms)
    assert spills == 2 * fits
    split = tk.DenseLaunch(6, 4, 2, 32, 2, 4, 8)
    assert tk.dense_cost(split, 1, 64, 64, 1024, sms) < tk.dense_cost(one, 1, 64, 64, 1024, sms)
    wide = tk.DenseLaunch(8, 4, 2, 32, 8, 1, 32)
    assert tk.dense_cost(wide, 1, 256, 256, 1024, sms) > tk.dense_cost(one, 1, 256, 256, 1024,
                                                                        sms)


def test_dense_plan_folds_only_where_the_folded_grid_fits():
    """``dense_plan`` folds a broadcast weight into the rows when the folded
    call's row tiles fit the grid's 65535; 600000 rows fold at 6 limbs (32
    rows a block tile) but not at 24 (8 rows a block tile), and then launch
    unfolded, each batch element's 300000 rows within the grid. A call that
    fits in neither way raises."""
    a = torch.zeros(2, 300000, 1)
    w = torch.zeros(1, 1, 3).expand(2, 1, 3)
    fa, fb, lay = tk.dense_plan(a, w, 6, H100_SMS)
    assert fa.shape == (1, 600000, 1) and fb.shape == (1, 1, 3)
    assert lay.grid(1, 600000, 3)[1] <= 65535
    ua, ub, lay = tk.dense_plan(a, w, 24, H100_SMS)
    assert ua is a and ub is w and lay.tile[0] == 8
    assert lay.grid(2, 300000, 3)[1] <= 65535 < lay.grid(1, 600000, 3)[1]
    with pytest.raises(ValueError, match="exceed the kernel grid"):
        tk.dense_plan(torch.zeros(1, 600000, 1), torch.zeros(1, 1, 3), 24, H100_SMS)


def test_dense_launch_splits_k_only_where_the_grid_is_small():
    """Calls whose output tiles alone cannot fill the card split K: the
    2-D router (4 x 16 outputs) over all 256 threads, mlp_in at decode (4
    rows after the fold) and attention at decode at least 16 ways. The LM
    head at decode (151936 columns) and the full-width training LM head
    need no split; narrow registers get their own capacities below 6
    limbs."""
    assert tk.dense_launch(6, 1, 4, 16, 6144, H100_SMS).ks == tk.DENSE_THREADS
    assert tk.dense_launch(6, 1, 4, 3072, 1024, H100_SMS).ks >= 16
    assert tk.dense_launch(6, 32, 2, 32, 128, H100_SMS).ks >= 16
    lm_decode = tk.dense_launch(6, 1, 4, 151936, 1024, H100_SMS)
    assert lm_decode.ks == 1 and lm_decode.grid(1, 4, 151936)[0] >= 2 * H100_SMS
    train_head = tk.dense_launch(6, 1, 256, 100352, 6144, H100_SMS)
    assert train_head.ks == 1 and train_head.tile[:2] == (32, 64)
    assert [tk.dense_launch(n, 1, 64, 3072, 1024, H100_SMS).lc
            for n in (1, 2, 3, 4, 5, 6)] == [2, 2, 4, 4, 6, 6]
    wide = tk.dense_launch(25, 1, 64, 3072, 1024, H100_SMS)
    assert wide.tm * wide.tn == 1


def test_sass_report_reads_ptxas_and_the_product_loop():
    """The SASS reader resolves labels, finds the loop whose own body forms
    the most products (not the tile-load loop, which stores as many values
    to shared memory as it forms products; not an outer loop, whose nested
    loops are left out of its body), and counts its instructions per
    product (a wide multiply with an addend is address arithmetic, not a
    product); the ptxas reader takes registers and spills per kernel."""
    from repro_torch.kernels import sass_report as S

    name = "_ZN12_GLOBAL__N_115fdp_gemm_kernelILi6ELb0EEEvPKj"
    sass = f"""
        Function : {name}
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
.L_x_1:
        /*0010*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0020*/                   STS.64 [R3], R4 ;
        /*0030*/               @P0 BRA `(.L_x_1) ;
.L_x_2:
        /*0040*/                   LDS.128 R8, [R2] ;
        /*0050*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0060*/                   SEL R5, R6, RZ, P1 ;
        /*0070*/                   IMAD.WIDE.U32 R6, R2, R3, RZ ;
        /*0078*/                   IMAD.WIDE.U32 R6, R2, 0x4, R8 ;
        /*0080*/              @!P2 BRA `(.L_x_2) ;
        /*0090*/                   STS.64 [R3], R4 ;
        /*00a0*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*00b0*/               @P3 BRA 0x10 ;
        /*00c0*/                   BRA 0xc0 ;
        /*00d0*/                   EXIT ;
"""
    body = S.sass_functions(sass)[name]
    assert [op for _, op, _, _ in body][:3] == ["LDC", "IMAD.WIDE.U32", "STS.64"]
    loop = S.product_loop(body)                 # the address multiply is no product
    assert loop["products"] == 2 and loop["instructions"] == 6 and loop["per_product"] == 3
    assert loop["opcodes"]["IMAD"] == 3 and loop["opcodes"]["SEL"] == 1
    # the outer loop (0x10-0xb0) forms one product and one store in its own
    # body, the nested loops' left out; with two more products there it
    # forms the most, and its own body counts: STS, 3 IMAD, BRA
    outer = sorted(body + [(0x98, "IMAD.WIDE.U32", None, " R6, R2, R3, RZ"),
                           (0x9c, "IMAD.WIDE.U32", None, " R8, R2, R3, RZ")])
    loop = S.product_loop(outer)
    assert loop["products"] == 3 and loop["instructions"] == 5
    assert loop["opcodes"] == {"IMAD": 3, "STS": 1, "BRA": 1}
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 72 registers, used 1 barriers, 384 bytes cmem[0]\n")
    assert S.template_args(name) == [6, 0]
    assert S.ptxas_usage(log) == {name: {"registers": 72, "spill_stores": 8,
                                         "spill_loads": 4}}
