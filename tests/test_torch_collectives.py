"""The port's collectives on a gloo world of 8 CPU ranks against the JAX
package: ``fdp_psum`` and ``gemm(reduce_axis=)`` (the K-sharded FDP GEMM),
its backward, ``reproducible_psum``, ``quantized_psum`` with error feedback
and the overflow guard, and the two gradient reducers; and the world itself
(``launch.mesh.spawn``: the backend rule, a rank that raises, a hung
collective, a world past its time).

One world of 8 ranks serves the whole module (``tests/_torch_mesh_worker.
collectives``, which imports no JAX); each rank holds K-shard r, or row r of
a psum payload. The expectations are the JAX package's, on the same numpy
inputs, in this process.

Tolerances, and why:
- Everything that goes through the limb register or an integer payload is
  bit-equal: the sharded FDP GEMM to JAX's unsharded ``fdp_gemm`` (every
  shard assignment, a one-limb register whose top limb wraps in int32, a
  2x4 mesh reduced over both axes), its register to JAX's
  ``carry_normalize`` of the per-shard limbs summed in int32, its backward
  to JAX's unsharded gradients, and the quantized collectives to JAX's
  quantizers applied per shard and summed in numpy. ``quantized_psum``'s
  scales are exact powers of two in the port; JAX's ``block_scale`` forms
  them with ``jnp.exp2``, inexact on XLA:CPU away from exponent 0 (ROADMAP
  section 3), so the expectation takes JAX's exponent and the exact power.
- Native float sums (the K-sharded native GEMM, the fp32 identity mode):
  within rtol 1e-5 / atol 1e-4 of a float64 product: another summation
  order than any single-device one.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import fdp as jfdp  # noqa: E402
from repro.core import qformat as JQ  # noqa: E402
from repro.core.accumulator import AccumulatorSpec as JSpec  # noqa: E402
from repro.parallel.collectives import _grid_quantize as j_grid_quantize  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402

import _torch_mesh_worker as W  # noqa: E402

torch.set_num_threads(1)

WORLD = 8
SPEC30, WRAP = JSpec(30, 30, -30), JSpec(2, 5, -8)
SPAWN = dict(timeout=240, collective_timeout=60)


def _data():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((8, 256)).astype(np.float32),
            "b": rng.standard_normal((256, 16)).astype(np.float32),
            # 8192 positive products a rank of ~2^15.85 on the 2^-8 grid of
            # a one-limb register: each rank's top limb stays under 2^31,
            # their sum over 8 ranks does not
            "wa": rng.uniform(14.5, 15.9, (2, 8 * 8192)).astype(np.float32),
            "wb": rng.uniform(14.5, 15.9, (8 * 8192, 2)).astype(np.float32),
            "x": rng.standard_normal((8, 64)).astype(np.float32),
            "g": (rng.standard_normal((8, 64)) * 0.1).astype(np.float32),
            "cg": (rng.standard_normal((8, 32)) * 0.1).astype(np.float32),
            "qw": rng.standard_normal((8, 3, 50)).astype(np.float32),
            "qv": (rng.standard_normal((8, 70)) * 1e-3).astype(np.float32),
            "perms": [list(range(8))] + [[int(p) for p in rng.permutation(8)]
                                         for _ in range(2)]}


@pytest.fixture(scope="module")
def world():
    data = _data()
    return data, TM.spawn(W.collectives, WORLD, args=(data,), **SPAWN)


def _shards(x, axis):
    return np.split(x, WORLD, axis=axis)


def _jax_register(a, b, spec):
    """carry_normalize of the per-shard registers summed in int32."""
    parts = [jfdp.fdp_gemm_limbs(jnp.asarray(al), jnp.asarray(bl), spec)
             for al, bl in zip(_shards(a, 1), _shards(b, 0))]
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return jacc.carry_normalize(spec, s)


# ---------------------------------------------------------------------------
# The K-sharded FDP GEMM
# ---------------------------------------------------------------------------
def test_fdp_psum_equals_unsharded_for_every_shard_assignment(world):
    data, res = world
    ref = np.asarray(jfdp.fdp_gemm(jnp.asarray(data["a"]), jnp.asarray(data["b"]), SPEC30))
    for r in res:
        for i in range(len(data["perms"])):
            np.testing.assert_array_equal(r[f"fdp_psum_{i}"], ref, err_msg=f"assignment {i}")
    reg = np.asarray(_jax_register(data["a"], data["b"], SPEC30))
    np.testing.assert_array_equal(res[0]["fdp_register_0"], reg)
    np.testing.assert_array_equal(np.asarray(jacc.to_float(SPEC30, jnp.asarray(reg))), ref)


def test_fdp_psum_top_limb_wrap(world):
    data, res = world
    local = np.stack([r["wrap_limbs_local"].astype(np.int64) for r in res])
    top = local[..., -1].sum(axis=0)
    assert np.any(np.abs(top) > 2 ** 31 - 1), "the case must wrap the int32 top limb"
    ref = np.asarray(jfdp.fdp_gemm(jnp.asarray(data["wa"]), jnp.asarray(data["wb"]), WRAP))
    want = np.asarray(jacc.to_float(WRAP, _jax_register(data["wa"], data["wb"], WRAP)))
    np.testing.assert_array_equal(want, ref)
    for r in res:
        np.testing.assert_array_equal(r["wrap"], ref)


@pytest.mark.parametrize("mode", ["simulate", "pallas", "native"])
def test_gemm_reduce_axis_matches_unsharded(world, mode):
    data, res = world
    a, b = jnp.asarray(data["a"]), jnp.asarray(data["b"])
    if mode == "native":
        want = data["a"].astype(np.float64) @ data["b"].astype(np.float64)
        for r in res:
            np.testing.assert_allclose(r["gemm_native"], want, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(r["gemm_grid_native"], want, rtol=1e-5, atol=1e-4)
        return
    ref = np.asarray(JD.gemm(a, b, site="probe", policy=JD.FDP91))
    np.testing.assert_array_equal(ref, np.asarray(jfdp.fdp_gemm(a, b, SPEC30)))
    for r in res:
        np.testing.assert_array_equal(r[f"gemm_{mode}"], ref)
        np.testing.assert_array_equal(r["gemm_grid_simulate"], ref)
    assert all(r[f"hook_saw_reduced_{m}"] for r in res for m in ("simulate", "pallas", "native"))


def test_gemm_reduce_axis_backward_is_local_and_makes_no_collective(world):
    import jax
    data, res = world
    loss = lambda x, y: JD.gemm(x, y, site="probe", policy=JD.FDP91).sum()
    da, db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(data["a"]), jnp.asarray(data["b"]))
    for rank, r in enumerate(res):
        assert r["bwd_all_reduce_calls"] == 0
        np.testing.assert_array_equal(r["grad_da"], _shards(np.asarray(da), 1)[rank])
        np.testing.assert_array_equal(r["grad_db"], _shards(np.asarray(db), 0)[rank])


# ---------------------------------------------------------------------------
# reproducible_psum, quantized_psum and the reducers
# ---------------------------------------------------------------------------
def _grid_sum(rows, lsb, width):
    """JAX's grid quantizer a shard, the integer sum in numpy."""
    q = np.stack([np.asarray(j_grid_quantize(jnp.asarray(x), lsb, width)) for x in rows])
    return q.sum(axis=0, dtype=np.int64).astype(np.int32)


def test_reproducible_psum(world):
    data, res = world
    spec = JSpec(8, 8, -16)
    s = _grid_sum(data["x"], spec.lsb, spec.width)
    want = s.astype(np.float32) * np.float32(2.0 ** -16)
    for r in res:
        np.testing.assert_array_equal(r["reproducible_psum"], want)
        np.testing.assert_array_equal(r["reproducible_psum_again"], want)
        np.testing.assert_array_equal(r["reproducible_pmean"], want / np.float32(WORLD))
    # the reference's own bound against the float sum
    np.testing.assert_allclose(want, data["x"].sum(0), atol=8 * 2.0 ** -16)


def _jax_quantized_psum(rows, residuals, bits, block):
    """quantized_psum(mean=True) of ``rows`` with error feedback, from
    JAX's block quantizers per shard; returns (out, new residuals)."""
    blocks = [np.asarray(JQ._to_blocks(jnp.asarray(x), block)) for x in rows]
    amax = np.max([np.abs(bl).max(axis=1) for bl in blocks], axis=0)
    _, scale = JQ.block_scale(jnp.asarray(amax), bits)
    scale = np.exp2(np.round(np.log2(np.asarray(scale, np.float64)))).astype(np.float32)
    lim = 2.0 ** (bits - 1) - 1
    size = rows[0].size

    def unblock(x):
        return x.reshape(-1)[:size].reshape(rows[0].shape)

    qs, new_res = [], []
    for x, bl, r in zip(rows, blocks, residuals):
        payload = bl + np.asarray(JQ._to_blocks(jnp.asarray(r), block))
        q = np.clip(np.round(payload / scale[:, None]), -lim, lim).astype(np.int32)
        qs.append(q)
        new_res.append((x + r) - unblock(q.astype(np.float32) * scale[:, None]))
    s = np.sum(qs, axis=0, dtype=np.int64).astype(np.int32)
    out = unblock(s.astype(np.float32) * scale[:, None]) / np.float32(len(rows))
    return out, new_res


def test_quantized_psum_error_feedback(world):
    data, res = world
    g = data["g"]
    resid = [np.zeros_like(x) for x in g]
    for _ in range(6):
        out, resid = _jax_quantized_psum(list(g), resid, 4, 32)
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["quantized_out"], out)
        np.testing.assert_array_equal(r["quantized_residual"], resid[rank])
    # the reference check's bounds: the mean within two grid steps of the
    # float mean, the residual bounded (block_scale's no-clip contract)
    amax = np.abs(g).reshape(WORLD, -1, 32).max(axis=(0, 2))
    step = np.exp2(np.ceil(np.log2(amax)) - 3 + 1)
    err = np.abs(res[0]["quantized_out"] - g.mean(0)).reshape(-1, 32)
    assert (err <= 2 * step[:, None]).all()
    rmax = np.abs(np.stack([r["quantized_residual"] for r in res])).reshape(
        WORLD, -1, 32).max(axis=(0, 2))
    assert (rmax <= 2 * step).all()
    for r in res:
        np.testing.assert_allclose(r["quantized_fp32"], g.sum(0), rtol=1e-5, atol=1e-4)


def test_quantized_psum_overflow_guard(world):
    _, res = world
    # benign payloads are silent; a spillover on rank 0 alone raises on
    # every rank (the flag is agreed before anyone raises); warn mode counts
    # one event a rank and goes on
    assert all(r["spillover_raised"] for r in res)
    assert [r["warn_events"] for r in res] == [1.0] * WORLD


def test_compressed_grad_reducer(world):
    data, res = world
    spec = JSpec(4, 2, -8)
    s = _grid_sum(data["cg"], spec.lsb, spec.width)
    want = (s.astype(np.float32) * np.float32(2.0 ** -8)) / np.float32(WORLD)
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["compressed_out"], want)
        q = np.asarray(j_grid_quantize(jnp.asarray(data["cg"][rank]), spec.lsb, spec.width))
        np.testing.assert_array_equal(r["compressed_residual"],
                                      data["cg"][rank] - q.astype(np.float32) * np.float32(2.0 ** -8))
    assert np.abs(res[0]["compressed_out"] - data["cg"].mean(0)).max() < 2.0 ** -8 * 2
    assert np.abs(np.stack([r["compressed_residual"] for r in res])).max() <= 2.0 ** -9 + 1e-7


def test_quantized_grad_reducer(world):
    data, res = world
    for leaf in ("w", "v"):
        rows = list(data[f"q{leaf}"])
        resid = [np.zeros_like(x) for x in rows]
        for _ in range(2):
            out, resid = _jax_quantized_psum(rows, resid, 8, 64)
        for rank, r in enumerate(res):
            np.testing.assert_array_equal(r[f"qred_{leaf}"], out)
            np.testing.assert_array_equal(r[f"qred_res_{leaf}"], resid[rank])


# ---------------------------------------------------------------------------
# The world: backend rule, failures, timeouts
# ---------------------------------------------------------------------------
def test_backend_rule():
    cpu = TM.rank_devices("cpu", 4)
    assert cpu == [torch.device("cpu")] * 4 and TM.backend_for(cpu) == "gloo"
    shared = TM.rank_devices("cuda:0", 4)
    assert TM.backend_for(shared) == "gloo"
    own = [torch.device("cuda", r) for r in range(4)]
    assert TM.backend_for(own) == "nccl"


def test_a_rank_that_raises_fails_the_spawn_with_its_traceback(capsys):
    t = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of a world of 2 raised first.*"
                                           r"rank 1 fails on purpose"):
        TM.spawn(W.raise_on_rank_one, 2, timeout=60, collective_timeout=30)
    assert time.monotonic() - t < 30
    assert "backend gloo" in capsys.readouterr().out


def test_a_hung_collective_fails_within_its_timeout():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of a world of 2 raised first"):
        TM.spawn(W.hang_on_rank_one, 2, timeout=60, collective_timeout=2)
    assert time.monotonic() - t < 30


def test_a_world_past_its_time_is_ended():
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="did not end within 5 s"):
        TM.spawn(W.hang_on_rank_one, 2, timeout=5, collective_timeout=60)
    assert time.monotonic() - t < 20


def test_spawn_returns_each_ranks_value():
    assert TM.spawn(W.rank_and_world, 3, timeout=60, collective_timeout=30) == \
        [(0, 3, "cpu"), (1, 3, "cpu"), (2, 3, "cpu")]


def test_no_file_is_left_behind(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    TM.spawn(W.rank_and_world, 2, timeout=60, collective_timeout=30)
    assert os.listdir(tmp_path) == []
