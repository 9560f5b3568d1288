"""Mesh-aware numerics in one process, case for case the reference's
``tests/test_mesh_numerics.py``: the partial-K register (``fdp_gemm_limbs``,
``merge_states``, ``fdp_psum``), the sharding-aware dispatch
(``gemm(reduce_axis=)``), the collective overflow guard, the launch profile
plumbing (``parse_mesh``, ``make_mesh``, ``distribution_for``,
``Distribution``), the mesh train step on a 1x1 mesh, and the mesh-reshape
workload on one rank. The worlds of several ranks are in
``test_torch_collectives.py`` and ``test_torch_mesh_train.py``.

Inputs are numpy draws shared with the JAX package. Tolerances: everything
through the limb register is bit-equal to JAX; native GEMMs (a summation
order of their own) to the port's own local GEMM, bit for bit, and to JAX
within rtol 1e-5 / atol 1e-5 where they are compared.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import fdp as jfdp  # noqa: E402
from repro.core.accumulator import AccumulatorSpec as JSpec  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models import layers as JLayers  # noqa: E402
from repro.workloads import mesh as JWM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import accumulator as acc  # noqa: E402
from repro_torch.core import fdp  # noqa: E402
from repro_torch.core.accumulator import AccumulatorSpec  # noqa: E402
from repro_torch.core.dispatch import FDP91, MXU_FP32, gemm  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.parallel.axes import axis_size, use_mesh  # noqa: E402
from repro_torch.parallel.collectives import (_grid_quantize, fdp_psum,  # noqa: E402
                                              reproducible_psum, validate_overflow)

torch.set_num_threads(1)

SPEC = AccumulatorSpec(ovf=30, msb=30, lsb=-30)
JSPEC = JSpec(ovf=30, msb=30, lsb=-30)


def _f32(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mesh1():
    return DeviceMesh((1,), ("x",))


# ---------------------------------------------------------------------------
# Partial-K reduction state: fdp_gemm_limbs / merge_states / fdp_psum
# ---------------------------------------------------------------------------
def test_fdp_gemm_limbs_is_the_gemm_register():
    a, b = _f32(0, (4, 32)), _f32(1, (32, 8))
    limbs = fdp.fdp_gemm_limbs(torch.from_numpy(a), torch.from_numpy(b), SPEC)
    assert tuple(limbs.shape) == (4, 8, SPEC.num_limbs)
    assert limbs.dtype == torch.int32
    np.testing.assert_array_equal(limbs.numpy(), np.asarray(
        jfdp.fdp_gemm_limbs(jnp.asarray(a), jnp.asarray(b), JSPEC)))
    np.testing.assert_array_equal(acc.to_float(SPEC, limbs).numpy(), np.asarray(
        jfdp.fdp_gemm(jnp.asarray(a), jnp.asarray(b), JSPEC)))


def test_merge_states_bit_identical_for_any_k_split():
    a, b = _f32(2, (4, 64)), _f32(3, (64, 8))
    ref = np.asarray(jfdp.fdp_gemm(jnp.asarray(a), jnp.asarray(b), JSPEC))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for splits in (2, 4, 8):
        s = 64 // splits
        parts = torch.stack([fdp.fdp_gemm_limbs(ta[:, i * s:(i + 1) * s],
                                                tb[i * s:(i + 1) * s], SPEC)
                             for i in range(splits)])
        merged = acc.merge_states(SPEC, parts)
        np.testing.assert_array_equal(acc.to_float(SPEC, merged).numpy(), ref)


def test_fdp_psum_single_device_identity():
    a, b = _f32(4, (4, 32)), _f32(5, (32, 8))
    ref = np.asarray(jfdp.fdp_gemm(jnp.asarray(a), jnp.asarray(b), JSPEC))
    with use_mesh(_mesh1()):
        out = acc.to_float(SPEC, fdp_psum(
            fdp.fdp_gemm_limbs(torch.from_numpy(a), torch.from_numpy(b), SPEC), "x", SPEC))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_fdp_psum_rejects_wrong_limb_count():
    with use_mesh(_mesh1()), pytest.raises(AssertionError, match="spec wants 6"):
        fdp_psum(torch.zeros((1, 3, 2), dtype=torch.int32), "x", SPEC)


# ---------------------------------------------------------------------------
# Sharding-aware dispatch: gemm(reduce_axis=...)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", [FDP91, MXU_FP32], ids=["fdp_simulate", "native"])
def test_gemm_reduce_axis_matches_local(policy):
    a, b = torch.from_numpy(_f32(6, (4, 32))), torch.from_numpy(_f32(7, (32, 8)))
    ref = gemm(a, b, site="probe", policy=policy)
    with use_mesh(_mesh1()):
        out = gemm(a, b, site="probe", policy=policy, reduce_axis="x")
    assert torch.equal(out, ref)
    if policy is FDP91:
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            jfdp.fdp_gemm(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), JSPEC)))
    else:
        np.testing.assert_allclose(out.numpy(), a.numpy() @ b.numpy(), rtol=1e-5, atol=1e-5)


def test_gemm_reduce_axis_backward_needs_no_collectives():
    """dA_loc = G·B_locᵀ, dB_loc = A_locᵀ·G are already the local shards of
    the full gradients: a K-sharded forward grads exactly like a local one."""
    a, b = torch.from_numpy(_f32(8, (4, 32))), torch.from_numpy(_f32(9, (32, 8)))

    def grads(**kw):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        gemm(x, y, site="probe", policy=FDP91, **kw).sum().backward()
        return x.grad, y.grad

    gref = grads()
    with use_mesh(_mesh1()):
        got = grads(reduce_axis="x")
    assert torch.equal(got[0], gref[0]) and torch.equal(got[1], gref[1])


def test_gemm_reduce_axis_fdp_rejects_batched():
    with use_mesh(_mesh1()), pytest.raises(
            NotImplementedError, match=r"sharded FDP contraction \(reduce_axis=...\) "
                                       "supports 2-D operands"):
        gemm(torch.zeros(2, 4, 8), torch.zeros(8, 4), site="probe", policy=FDP91,
             reduce_axis="x")


def test_gemm_reduce_axis_outside_a_mesh_raises():
    with pytest.raises(NameError, match="no mesh is in effect"):
        gemm(torch.zeros(4, 8), torch.zeros(8, 4), site="probe", policy=MXU_FP32,
             reduce_axis="x")
    with use_mesh(_mesh1()), pytest.raises(NameError, match="unbound axis name 'model'"):
        gemm(torch.zeros(4, 8), torch.zeros(8, 4), site="probe", policy=MXU_FP32,
             reduce_axis="model")


# ---------------------------------------------------------------------------
# Collective payload overflow guard + axis_size
# ---------------------------------------------------------------------------
def test_overflow_guard_raises_under_validation():
    with validate_overflow():
        with pytest.raises(OverflowError, match="grid_quantize"):
            _grid_quantize(torch.tensor([1e9]), -16, 16)


def test_overflow_guard_clean_path_and_default_off():
    with validate_overflow():
        q = _grid_quantize(torch.tensor([0.25]), -16, 16)
    assert int(q[0]) == 16384
    # off by default: saturating payloads clip silently (production path)
    q = _grid_quantize(torch.tensor([1e9]), -16, 16)
    assert int(q[0]) == 2 ** 15 - 1
    with pytest.raises(ValueError, match="expected 'raise' or 'warn'"):
        with validate_overflow(mode="loud"):
            pass


def test_quantize_tree_round_trips_like_the_reference():
    from repro.parallel.collectives import dequantize_tree as j_deq
    from repro.parallel.collectives import quantize_tree as j_q
    from repro_torch.configs import get_config as tget
    from repro_torch.models import init
    from repro_torch.parallel.collectives import dequantize_tree, quantize_tree
    spec, jspec = AccumulatorSpec(4, 4, -12), JSpec(4, 4, -12)
    tree = {"w": _f32(11, (3, 5)), "b": _f32(12, (7,)) * 0.01}
    q = quantize_tree({k: torch.from_numpy(v) for k, v in tree.items()}, spec)
    jq = j_q({k: jnp.asarray(v) for k, v in tree.items()}, jspec)
    for k in tree:
        assert q[k].dtype == torch.int32
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_array_equal(dequantize_tree(q, spec)[k].numpy(),
                                      np.asarray(j_deq(jq, jspec)[k]))
    module = init(tget("paper-mlp").reduced(), 0, device="cpu")
    mq = quantize_tree(module, spec)
    assert list(mq) == [k for k, _ in module.named_parameters()]
    back = dequantize_tree(mq, spec, like=module)
    for k, p in module.named_parameters():
        assert back[k].dtype == p.dtype
        assert float((back[k] - p.detach()).abs().max()) <= 2.0 ** -13


def test_axis_size_and_mean_psum():
    x = torch.from_numpy(_f32(10, (1, 16)))
    with use_mesh(_mesh1()):
        out = reproducible_psum(x[0], "x", AccumulatorSpec(8, 8, -16), mean=True)
        assert axis_size("x") == 1 and axis_size(("x",)) == 1
    np.testing.assert_allclose(out.numpy(), x[0].numpy(), atol=2.0 ** -16)


# ---------------------------------------------------------------------------
# Launch profile plumbing
# ---------------------------------------------------------------------------
def test_parse_mesh():
    from repro_torch.launch.sharding import PROFILES, parse_mesh
    assert PROFILES == JS.PROFILES
    for spec in ("2x4", "8", "1X8", "4×2"):
        assert parse_mesh(spec) == JS.parse_mesh(spec)
    assert parse_mesh("2x4") == (2, 4) and parse_mesh("8") == (8, 1)
    for bad in ("2x4x2", "ax4"):
        with pytest.raises(ValueError, match="bad mesh spec"):
            parse_mesh(bad)


def test_distribution_for_carries_policy():
    from repro_torch.launch.sharding import distribution_for, make_mesh
    from repro_torch.models import LOCAL, Distribution
    assert [f.name for f in dataclasses.fields(Distribution)] == \
        [f.name for f in dataclasses.fields(JLayers.Distribution)]
    assert LOCAL == Distribution() and LOCAL.dp == JLayers.LOCAL.dp == "data"
    assert Distribution(dp_axes=("pod", "data")).dp == ("pod", "data")
    mesh = make_mesh("1x1")
    assert (mesh.shape, mesh.axis_names) == ((1, 1), ("data", "model"))
    dist = distribution_for(mesh, "decode_tp", numerics_policy=FDP91)
    assert dist.joint_tp and dist.numerics_policy is FDP91
    assert distribution_for(mesh, "fsdp").numerics_policy is None
    with pytest.raises(ValueError, match="unknown profile"):
        distribution_for(mesh, "nope")
    with pytest.raises(ValueError, match="mesh 3x9 wants 27 devices, have 1"):
        make_mesh("3x9")
    x = torch.ones(2)
    assert LOCAL.constrain(x, "data") is x
    # with a mesh too: the rank's block already has the named placement
    assert dist.constrain(x, "data") is x


def test_make_test_mesh_and_dp_axes_of():
    import types
    from repro.launch.mesh import dp_axes_of as j_dp_axes_of
    from repro_torch.launch.mesh import dp_axes_of, make_test_mesh
    mesh = make_test_mesh((1, 1))
    assert (mesh.shape, mesh.axis_names, mesh.size, mesh.coords) == \
        ((1, 1), ("data", "model"), 1, (0, 0))
    assert dp_axes_of(mesh) == j_dp_axes_of(mesh) == ("data",)
    pod = types.SimpleNamespace(axis_names=("pod", "data", "model"))
    assert dp_axes_of(pod) == j_dp_axes_of(pod) == ("pod", "data")
    with pytest.raises(ValueError, match="wants 4 ranks, the world has 1"):
        make_test_mesh((2, 2))
    with pytest.raises(ValueError, match="do not pair up"):
        DeviceMesh((1, 1), ("data", "data"))


def _paper_mlp():
    from repro_torch.workloads import WorkloadContext
    cfg = get_config("paper-mlp").reduced()
    return cfg, WorkloadContext.for_model(cfg, device="cpu")


def _flat(params):
    return torch.cat([p.detach().reshape(-1) for _, p in params.named_parameters()])


def test_make_train_step_policy_falls_back_to_dist():
    from repro_torch.models import Distribution
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import adamw

    cfg, ctx = _paper_mlp()
    opt = adamw(lr=1e-3)
    dist = Distribution(mesh=None, numerics_policy=MXU_FP32)
    step = make_train_step(cfg, opt, dist, remat="none")
    with torch.no_grad():
        init = {k: p.clone() for k, p in ctx.params.named_parameters()}
    (params, _), metrics = step((ctx.params, opt.init(ctx.params)), ctx.grad_batch)
    assert np.isfinite(float(metrics["loss"]))
    got = _flat(params)
    with torch.no_grad():
        for k, p in ctx.params.named_parameters():
            p.copy_(init[k])
    explicit = make_train_step(cfg, opt, remat="none", numerics_policy=MXU_FP32)
    (params, _), _ = explicit((ctx.params, opt.init(ctx.params)), ctx.grad_batch)
    assert torch.equal(got, _flat(params))
    with pytest.raises(NotImplementedError, match="make_mesh_train_step"):
        make_train_step(cfg, opt, Distribution(mesh=DeviceMesh((1, 1))))


def test_make_mesh_train_step_1x1_matches_local():
    """On the degenerate 1x1 mesh the sharded step is the local step."""
    from repro_torch.launch.sharding import distribution_for, make_mesh
    from repro_torch.train.loop import make_mesh_train_step, make_train_step
    from repro_torch.train.optimizer import adamw

    cfg, ctx = _paper_mlp()
    opt = adamw(lr=1e-3)
    with torch.no_grad():
        init = {k: p.clone() for k, p in ctx.params.named_parameters()}

    def run(step):
        with torch.no_grad():
            for k, p in ctx.params.named_parameters():
                p.copy_(init[k])
        (params, _), metrics = step((ctx.params, opt.init(ctx.params)), ctx.grad_batch)
        assert np.isfinite(float(metrics["loss"]))
        return _flat(params)

    dist = distribution_for(make_mesh("1x1"), "ddp", numerics_policy=MXU_FP32)
    fixed = run(make_mesh_train_step(cfg, opt, dist, fdp_grad_spec=AccumulatorSpec(10, 10, -20)))
    assert not torch.equal(fixed, torch.cat([p.reshape(-1) for p in init.values()]))
    # the float mean over one rank is the local gradient: the local step
    local = run(make_train_step(cfg, opt, remat="none", numerics_policy=MXU_FP32))
    assert torch.equal(run(make_mesh_train_step(cfg, opt, dist)), local)


# ---------------------------------------------------------------------------
# Mesh-reshape workload + report provenance
# ---------------------------------------------------------------------------
def test_mesh_workload_registered_and_runs():
    from repro_torch.workloads import (MeshReshapeStability, WorkloadContext,
                                       available_workloads, build_validators)
    assert "mesh" in available_workloads()
    (v,) = build_validators(("mesh",), WorkloadContext(budget_bits=10.0, device="cpu"))
    assert isinstance(v, MeshReshapeStability)
    rep = v.run(FDP91)
    assert rep.passed and rep.mesh == "1x1"
    assert rep.to_json()["mesh"] == "1x1"
    # the reference's report on one device, field for field
    assert (rep.score, rep.threshold, rep.site_attribution) == \
        (53.0, 10.0, {"workload_probe": 53.0})
    assert rep.details == {"mesh_shapes": "1x1", "n_sites_probed": 1,
                           "bit_identical_sites": 1, "weakest_site": "workload_probe"}


def test_mesh_shapes_enumerates_factorizations():
    from repro_torch.workloads.mesh import MESH_CAP_BITS, mesh_shapes
    assert mesh_shapes(8) == [(1, 8), (2, 4), (4, 2), (8, 1)]
    assert mesh_shapes(1) == [(1, 1)]
    assert all(mesh_shapes(n) == JWM.mesh_shapes(n) for n in range(1, 13))
    assert MESH_CAP_BITS == JWM.MESH_CAP_BITS


def test_report_mesh_field_absent_by_default():
    from repro_torch.workloads import ValidationReport
    rep = ValidationReport(workload="w", score=1.0, threshold=0.0)
    assert rep.mesh is None and "mesh" not in rep.to_json()
    with_mesh = dataclasses.replace(rep, mesh="2x4")
    assert with_mesh.to_json()["mesh"] == "2x4"
