"""Rank functions of the port's multi-process tests. ``repro_torch.launch.mesh.
spawn`` starts the ranks, which import this module (never a test file):
it imports torch and the port only, never JAX, so a rank starts in seconds.
Each function runs on every rank of a world and returns numpy arrays and
plain values; the tests hold them against the JAX package in their own
process.
"""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import accumulator as acc
from repro_torch.core import dispatch as TD
from repro_torch.core import fdp
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.formats import FP32
from repro_torch.core.qformat import QuantConfig
from repro_torch.launch.mesh import DeviceMesh, world_size
from repro_torch.parallel.axes import use_mesh
from repro_torch.launch.serve import FDP91_KERNEL
from repro_torch.launch.sharding import distribution_for, make_mesh
from repro_torch.models import Transformer, params_from_numpy, params_to_numpy
from repro_torch.obs.registry import default_registry
from repro_torch.parallel import collectives as C
from repro_torch.train.loop import make_loss_fn, make_mesh_train_step, sharded_value_and_grad
from repro_torch.train.optimizer import adamw
from repro_torch.workloads import MeshReshapeStability

SPEC30 = AccumulatorSpec(30, 30, -30)
WRAP = AccumulatorSpec(2, 5, -8)           # 16 bits: one limb, the top one
GRAD_SPEC = AccumulatorSpec(10, 10, -20)
GEMM_POLICIES = {"simulate": TD.FDP91, "pallas": FDP91_KERNEL, "native": TD.MXU_FP32}


def _np(t):
    return t.detach().cpu().numpy()


def _shard(x, axis, n, r):
    k = x.shape[axis] // n
    return x.narrow(axis, r * k, k)


def broadcast_params(params: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``params`` set to rank ``src``'s, in
    place, in ``named_parameters`` order: one draw serves the world."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(params.parameters()) + list(params.buffers()):
            dist.broadcast(t.data, src)


def _count_all_reduce(fn):
    """fn() with every ``torch.distributed.all_reduce`` call counted."""
    calls = [0]
    orig = dist.all_reduce

    def counting(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    dist.all_reduce = counting
    try:
        out = fn()
    finally:
        dist.all_reduce = orig
    return out, calls[0]


def collectives(dev, data: dict) -> dict:
    """Every collective and the K-sharded GEMM on a world of 8 ranks; rank
    r holds K-shard r (and row r of the psum payloads)."""
    n, r = dist.get_world_size(), dist.get_rank()
    t = {k: torch.from_numpy(v).to(dev) for k, v in data.items() if isinstance(v, np.ndarray)}
    x = DeviceMesh((n,), ("x",))
    grid = DeviceMesh((2, n // 2), ("data", "model"))
    out = {}
    with use_mesh(x):
        # fdp_psum over every shard assignment of the perms (the reference's
        # check_fdp_limb_psum), and a one-limb register whose top limb wraps
        for i, perm in enumerate(data["perms"]):
            idx = torch.from_numpy(np.concatenate(
                [np.arange(p * 32, (p + 1) * 32) for p in perm])).to(dev)
            a, b = t["a"][:, idx], t["b"][idx]
            limbs = fdp.fdp_gemm_limbs(_shard(a, 1, n, r), _shard(b, 0, n, r), SPEC30)
            reg = C.fdp_psum(limbs, "x", SPEC30)
            out[f"fdp_psum_{i}"] = _np(acc.to_float(SPEC30, reg))
            out[f"fdp_register_{i}"] = _np(reg)
        limbs = fdp.fdp_gemm_limbs(_shard(t["wa"], 1, n, r), _shard(t["wb"], 0, n, r), WRAP)
        out["wrap_limbs_local"] = _np(limbs)
        out["wrap"] = _np(acc.to_float(WRAP, C.fdp_psum(limbs, "x", WRAP)))

        # gemm(reduce_axis=) and its backward, one collective-free pass
        al, bl = _shard(t["a"], 1, n, r), _shard(t["b"], 0, n, r)
        seen = []
        remove = TD.add_trace_hook(lambda site, cfg, a_, b_, y: seen.append((site, y)))
        try:
            for mode, pol in GEMM_POLICIES.items():
                with torch.no_grad():
                    y = TD.gemm(al, bl, site="probe", policy=pol, reduce_axis="x")
                out[f"gemm_{mode}"] = _np(y)
                out[f"hook_saw_reduced_{mode}"] = (seen[-1][0] == "probe"
                                                   and torch.equal(seen[-1][1], y))
        finally:
            remove()
        a_req, b_req = al.clone().requires_grad_(), bl.clone().requires_grad_()
        y = TD.gemm(a_req, b_req, site="probe", policy=TD.FDP91, reduce_axis="x")
        (da, db), calls = _count_all_reduce(
            lambda: torch.autograd.grad(y.sum(), (a_req, b_req)))
        out.update(grad_da=_np(da), grad_db=_np(db), bwd_all_reduce_calls=calls)
    with use_mesh(grid):
        with torch.no_grad():
            out["gemm_grid_simulate"] = _np(TD.gemm(al, bl, site="probe", policy=TD.FDP91,
                                                    reduce_axis=("data", "model")))
            out["gemm_grid_native"] = _np(TD.gemm(al, bl, site="probe", policy=TD.MXU_FP32,
                                                  reduce_axis=("model", "data")))

    dp = DeviceMesh((n,), ("dp",))
    with use_mesh(dp):
        spec = AccumulatorSpec(8, 8, -16)
        xr = t["x"][r]
        out["reproducible_psum"] = _np(C.reproducible_psum(xr, "dp", spec))
        out["reproducible_psum_again"] = _np(C.reproducible_psum(xr, "dp", spec))
        out["reproducible_pmean"] = _np(C.reproducible_psum(xr, "dp", spec, mean=True))

        # quantized_psum with error feedback over six steps
        cfg = QuantConfig(4, 32)
        g = t["g"][r]
        res = torch.zeros_like(g)
        for _ in range(6):
            q_out, res = C.quantized_psum(g, "dp", cfg, mean=True, residual=res)
        out["quantized_out"], out["quantized_residual"] = _np(q_out), _np(res)
        out["quantized_fp32"] = _np(C.quantized_psum(g, "dp", QuantConfig(mode="fp32")))
        with C.validate_overflow():
            C.quantized_psum(g, "dp", cfg, mean=True, residual=torch.zeros_like(g))
        try:
            with C.validate_overflow():      # only rank 0 spills over: all raise
                C.quantized_psum(g, "dp", cfg, mean=True,
                                 residual=torch.full_like(g, 100.0 if r == 0 else 0.0))
            out["spillover_raised"] = False
        except OverflowError:
            out["spillover_raised"] = True
        events = default_registry().counter("repro_overflow_events_total", "",
                                            ("site", "source"))
        before = events.value(site="grad_psum@coll", source="collective")
        with C.validate_overflow(mode="warn"):
            C.quantized_psum(g, "dp", cfg, residual=torch.full_like(g, 100.0))
        out["warn_events"] = events.value(site="grad_psum@coll", source="collective") - before

        # the gradient reducers
        red = C.CompressedGradReducer(AccumulatorSpec(4, 2, -8), "dp")
        grads = {"g": t["cg"][r]}
        c_out, c_res = red.reduce(grads, red.init(grads))
        out["compressed_out"], out["compressed_residual"] = _np(c_out["g"]), _np(c_res["g"])
        qred = C.QuantizedGradReducer(QuantConfig(8, 64), "dp")
        tree = {"w": t["qw"][r], "v": t["qv"][r]}
        q_res = qred.init(tree)
        for _ in range(2):
            q_mean, q_res = qred.reduce(tree, q_res)
        out.update({f"qred_{k}": _np(v) for k, v in q_mean.items()})
        out.update({f"qred_res_{k}": _np(v) for k, v in q_res.items()})
    return out


def mesh_train(dev, tree: dict, batch: dict, plan_path: str, shapes: list) -> dict:
    """paper-mlp (reduced) over the world: the mesh workload under the zoo
    plan and under every one of its sites in ``simulate`` ⟨30,30,-30⟩, and
    one ``make_mesh_train_step`` a factorization and policy, from the
    carried weights (rank 0's, broadcast); and, under the zoo plan on the
    first shape, that step's gradients after the fixed-point mean."""
    cfg = get_config("paper-mlp").reduced()
    r = dist.get_rank()
    if r == 0:
        params = params_from_numpy(tree, cfg, dev)
    else:
        params = Transformer(cfg, gen=None, device=dev)
    broadcast_params(params)
    init = {k: p.detach().clone() for k, p in params.named_parameters()}
    zoo = TD.policy_from_plan(plan_path)
    fdp_policy = fdp_site_policy(zoo)
    out = {"reports": {}, "stepped": {}, "metrics": {}}
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    meshes = {tuple(shape): make_mesh(tuple(shape)) for shape in shapes}
    out["grads"] = reduced_grads(cfg, params, meshes[tuple(shapes[0])], zoo, tb)
    for name, pol in (("zoo", zoo), ("fdp", fdp_policy)):
        out["reports"][name] = MeshReshapeStability(
            cfg=cfg, params=params, seed=0, device=dev).run(pol).to_json()
        for shape in shapes:
            with torch.no_grad():
                for k, p in params.named_parameters():
                    p.copy_(init[k])
            opt = adamw(lr=1e-3)
            dist_ = distribution_for(meshes[tuple(shape)], "ddp", numerics_policy=pol)
            step = make_mesh_train_step(cfg, opt, dist_, fdp_grad_spec=GRAD_SPEC)
            (stepped, _), metrics = step((params, opt.init(params)), tb)
            key = f"{name}/{shape[0]}x{shape[1]}"
            out["stepped"][key] = params_to_numpy(stepped, cfg)
            out["metrics"][key] = {k: float(v) for k, v in metrics.items()}
    return out


def reduced_grads(cfg, params, mesh, policy, batch: dict) -> dict:
    """The gradients of ``make_mesh_train_step``'s step after the fixed-point
    mean over ``mesh`` (``sharded_value_and_grad`` on this rank's slice of
    the global ``batch``), as the reference's tree."""
    vg = sharded_value_and_grad(make_loss_fn(cfg, remat="none"), tuple(mesh.axis_names),
                                fdp_grad_spec=GRAD_SPEC)
    b = next(iter(batch.values())).shape[0] // mesh.size
    local = {k: v[mesh.rank * b:(mesh.rank + 1) * b] for k, v in batch.items()}
    with use_mesh(mesh), TD.use_policy(policy):
        _, grads = vg(params, local)
    return params_to_numpy(grads, cfg)


def fdp_site_policy(zoo):
    """Every site the zoo plan names, in ``simulate`` at ⟨30,30,-30⟩ fp32
    (the zoo plans are native everywhere, so they probe no FDP site)."""
    cfg = TD.GemmConfig(FP32, SPEC30, "simulate")
    pol = TD.NumericsPolicy(TD.GemmConfig(FP32, None, "native"), name="fdp_sites")
    for pat, _ in zoo.overrides:
        pol = pol.with_override(pat, cfg)
    return pol


def mesh_step_card(dev, shapes: list) -> dict:
    """Card-only: reduced paper-mlp under the 91-bit kernel policy, one
    fixed-point mesh step a factorization from seed 0, with the dense
    kernel's launches and the FDP dispatches; and fdp_psum against the
    dense kernel."""
    from repro_torch.kernels import fdp_gemm as K
    from repro_torch.models import init as model_init
    n, r = dist.get_world_size(), dist.get_rank()
    cfg = get_config("paper-mlp").reduced()
    out = {"stepped": {}, "launches": {}, "backends": {}}
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(16, 512, generator=gen).to(dev)
    b = torch.randn(512, 96, generator=gen).to(dev)
    want = K.fdp_gemm(a[None], b[None], spec=SPEC30, fmt=FP32)[0]
    with use_mesh(DeviceMesh((n,), ("x",))):
        limbs = fdp.fdp_gemm_limbs(_shard(a, 1, n, r), _shard(b, 0, n, r), SPEC30)
        out["fdp_psum_equals_kernel"] = torch.equal(
            acc.to_float(SPEC30, C.fdp_psum(limbs, "x", SPEC30)), want)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (n, 8), generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (n, 8), generator=gen)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    for shape in shapes:
        params = model_init(cfg, 0, device=dev)
        opt = adamw(lr=1e-3)
        mesh = make_mesh(tuple(shape))
        out["backends"][mesh.describe()] = mesh.backends()
        step = make_mesh_train_step(cfg, opt, distribution_for(mesh, "ddp", FDP91_KERNEL),
                                    fdp_grad_spec=GRAD_SPEC)
        TD.reset_sites_seen()
        K.fdp_gemm.launches = 0
        step((params, opt.init(params)), batch)
        torch.cuda.synchronize()
        out["launches"][mesh.describe()] = (K.fdp_gemm.launches,
                                            sum(TD.site_calls().values()))
        out["stepped"][mesh.describe()] = {k: _np(p) for k, p in params.named_parameters()}
    return out


def sharded_collectives_card(dev) -> dict:
    """Card-only: ``all_gather``, ``psum_scatter``, ``all_to_all`` (tiled
    and not) and ``axis_index`` over each axis of the 1x4 and 2x2 meshes on
    CUDA tensors against the same ops on host tensors, and the ops gloo
    stages through the host."""
    from repro_torch.launch.mesh import staged_ops
    from repro_torch.parallel import axes as A
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.randn(4, 8, 12, generator=torch.Generator().manual_seed(r))
    out = {"equal": {}}
    for shape in ((1, n), (2, n // 2)):
        mesh = make_mesh(shape)
        with use_mesh(mesh):
            for axis in mesh.axis_names:
                if mesh.axis_size(axis) == 1:
                    continue
                res = {}
                for t in (x.to(dev), x):
                    res[t.device.type] = {
                        "all_gather": A.all_gather(t, axis, axis=1, tiled=True),
                        "all_gather_stacked": A.all_gather(t, axis, axis=0),
                        "psum_scatter": A.psum_scatter(t, axis, scatter_dimension=0,
                                                       tiled=True),
                        "all_to_all": A.all_to_all(t, axis, 0, 2, tiled=True),
                        "axis_index": torch.tensor(A.axis_index(axis))}
                for op, y in res["cuda"].items():
                    out["equal"][f"{mesh.describe()} {axis} {op}"] = (
                        y.is_cuda or op == "axis_index") and torch.equal(y.cpu(), res["cpu"][op])
    out["staged"] = staged_ops()
    return out


def rank_and_world(dev):
    return dist.get_rank(), dist.get_world_size(), str(dev)


def raise_on_rank_one(dev):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hang_on_rank_one(dev):
    """Rank 0 enters an all-reduce that rank 1 never joins."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    else:
        import time
        time.sleep(120)


def encdec_vlm_on_a_mesh(dev) -> dict:
    """``forward``, ``prefill``, ``decode_step`` and ``serve`` of reduced
    whisper-large-v3 and paligemma-3b on a 1 x world mesh: {arch: {call:
    the message each raises (None when it does not)}}."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, forward, init, init_cache, prefill
    out = {}
    for arch in ("whisper-large-v3", "paligemma-3b"):
        cfg = get_config(arch).reduced()
        params = init(cfg, seed=0, device=dev)
        d = distribution_for(make_mesh((1, world_size())))
        toks = torch.zeros((2, 4), dtype=torch.long)
        batch = {"tokens": toks,
                 "frames": torch.zeros((2, cfg.enc_seq, cfg.d_model)),
                 "patches": torch.zeros((2, cfg.n_patches, cfg.d_model))}
        cache = lambda: init_cache(cfg, 2, 8, dtype=torch.float32, device=dev)
        out[arch] = {}
        for name, call in (
                ("forward", lambda: forward(params, cfg, batch, d)),
                ("prefill", lambda: prefill(params, cfg, batch, cache(), d)),
                ("decode_step", lambda: decode_step(params, cfg, cache(), toks[:, :1], d)),
                ("serve", lambda: serve(cfg, params, toks, 2, device=dev, dist=d))):
            try:
                call()
                out[arch][name] = None
            except NotImplementedError as e:
                out[arch][name] = str(e)
    return out


def ssm_on_a_mesh(dev) -> dict:
    """``forward`` and ``serve`` of reduced mamba2-1.3b on a 1 x world mesh:
    the message each raises (None when it does not)."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import forward, init
    cfg = get_config("mamba2-1.3b").reduced()
    params = init(cfg, seed=0, device=dev)
    d = distribution_for(make_mesh((1, world_size())))
    toks = torch.zeros((2, 4), dtype=torch.long)
    out = {}
    for name, call in (("forward", lambda: forward(params, cfg, {"tokens": toks}, d)),
                       ("serve", lambda: serve(cfg, params, toks, 2, device=dev, dist=d))):
        try:
            call()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out
