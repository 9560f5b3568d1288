"""Rank functions of the sharded-forward tests (``tests/test_torch_sharded.py``).
``repro_torch.launch.mesh.spawn`` starts the ranks, which import this module
(never a test file): torch and the port only, never JAX. Each function runs
on every rank of a world and returns numpy arrays (global tensors, gathered
from the ranks' blocks) and plain values; the tests hold them against the
port's local blocks and the JAX package in their own process.
"""

import copy

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dispatch as TD
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.launch.serve import serve
from repro_torch.launch.sharding import distribution_for, make_mesh, shard_params
from repro_torch.models import Distribution, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.transformer import block_of, forward, gather_block, seq_sharded
from repro_torch.parallel import axes as A

POLICIES = {"native": TD.MXU_FP32, "fdp91": TD.FDP91}


def _np(t):
    return t.detach().cpu().numpy()


def moe_module(tree: dict, cfg) -> M.MoE:
    p = M.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts)
    with torch.no_grad():
        for k, v in tree.items():
            getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    return p


def mlp_module(tree: dict, cfg) -> L.MLP:
    p = L.MLP(cfg.d_model, cfg.d_ff)
    with torch.no_grad():
        for k, v in tree.items():
            getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    return p


def _block(x: torch.Tensor, dist, seq: bool) -> torch.Tensor:
    rows, pos = block_of(dist, x.shape[0], x.shape[1] if seq else 1)
    return x[rows, pos] if seq else x[rows]


def _full_expert_grads(p, dist, moe_impl: str) -> dict:
    """The experts' gradient, whole on every rank: each slice's shares summed
    over the ranks that hold it, then the slices gathered; the router's
    shares summed over the world."""
    mesh = dist.mesh
    out = {"router": mesh.all_reduce(p.router.grad, mesh.axis_names)}
    for name in ("w_in", "w_gate", "w_out"):
        g = getattr(p, name).grad
        if dist.joint_tp:
            # one slice a rank, in the flattened (data, model) order
            dim = 2 if name != "w_out" else 1
            for axis in reversed(M.joint_axes(dist)):
                g = mesh.all_gather(g, axis, dim)
        else:
            g = mesh.all_reduce(g, dist.dp_axes)
            dim = 0 if moe_impl == "ep" else (2 if name != "w_out" else 1)
            g = mesh.all_gather(g, dist.tp_axis, dim)
        out[name] = g
    return {k: _np(v) for k, v in out.items()}


def moe_cases(dist, cfg, tree, x_seq, x_dec, grad: bool, policies) -> dict:
    """TP moe_block on the sequence-sharded, decode and (with ``dist``'s
    ``joint_tp`` twin) joint branches, gathered; with ``grad``, x's gradient
    and the experts' (MXU_FP32) for a fixed cotangent."""
    joint = Distribution(mesh=dist.mesh, dp_axes=dist.dp_axes, tp_axis=dist.tp_axis,
                         joint_tp=True)
    full = moe_module(tree, cfg)
    out = {}
    for tag, d_, x, seq in (("seq", dist, x_seq, True), ("dec", dist, x_dec, False),
                            ("joint", joint, x_dec, False)):
        p = shard_params(copy.deepcopy(full), cfg, d_)
        for pol in policies:
            with TD.use_policy(POLICIES[pol]), torch.no_grad():
                y = M.moe_block(_block(x, d_, seq), p, cfg, d_, seq_sharded=seq)
            out[f"{tag}/{pol}"] = _np(gather_block(y, d_, x.shape[1] if seq else 1))
        if grad:
            xb = _block(x, d_, seq).clone().requires_grad_()
            c = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
            with TD.use_policy(TD.MXU_FP32):
                y = M.moe_block(xb, p, cfg, d_, seq_sharded=seq)
                (y * _block(c, d_, seq)).sum().backward()
            out[f"{tag}/grad_x"] = _np(gather_block(xb.grad, d_, x.shape[1] if seq else 1))
            out[f"{tag}/grad_w"] = _full_expert_grads(p, d_, "tp")
    return out


def ep_cases(dist, cfg, tree, x, grad: bool, policies, tag: str = "ep") -> dict:
    """moe_block_ep (capacity factor 8) on the rank's (dp, tp) block,
    gathered, with the rows it dropped summed over the world."""
    p = shard_params(moe_module(tree, cfg), cfg, dist, "ep")
    out = {}
    for pol in policies:
        with TD.use_policy(POLICIES[pol]), torch.no_grad():
            y, dropped = M.moe_block_ep(_block(x, dist, True), p, cfg, dist,
                                        capacity_factor=8.0, return_dropped=True)
        out[f"{tag}/{pol}"] = _np(gather_block(y, dist, x.shape[1]))
        out[f"{tag}/{pol}/dropped"] = int(dist.mesh.all_reduce(dropped, dist.mesh.axis_names))
    if grad:
        xb = _block(x, dist, True).clone().requires_grad_()
        c = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
        with TD.use_policy(TD.MXU_FP32):
            y = M.moe_block_ep(xb, p, cfg, dist, capacity_factor=8.0)
            (y * _block(c, dist, True)).sum().backward()
        out["ep/grad_x"] = _np(gather_block(xb.grad, dist, x.shape[1]))
        out["ep/grad_w"] = _full_expert_grads(p, dist, "ep")
    return out


def mlp_cases(dist, cfg, tree, x_seq, x_dec, policies) -> dict:
    """The Megatron mlp_block at decode (x the rank's rows) and, under
    ``mlp_pattern="megatron"``, on a sharded sequence; gathered."""
    p = mlp_module(tree, cfg)
    meg = Distribution(mesh=dist.mesh, dp_axes=dist.dp_axes, tp_axis=dist.tp_axis,
                       mlp_pattern="megatron")
    out = {}
    for pol in policies:
        with TD.use_policy(POLICIES[pol]), torch.no_grad():
            y = L.mlp_block(_block(x_dec, dist, False), p, cfg, dist)
            out[f"mlp_dec/{pol}"] = _np(gather_block(y, dist, 1))
            y = L.mlp_block(_block(x_seq, meg, True), p, cfg, meg, seq_sharded=True)
            out[f"mlp_seq/{pol}"] = _np(gather_block(y, meg, x_seq.shape[1]))
    return out


def forward_cases(dist, cfg, tree, tokens, grad: bool, policies) -> dict:
    """The sequence-parallel forward of a dense model, gathered; with
    ``grad``, every parameter's gradient (shares summed over the world) of
    the loss sum(logits * c) under MXU_FP32."""
    params = params_from_numpy(tree, cfg, device="cpu")
    toks = torch.from_numpy(tokens)
    S = toks.shape[1]
    out = {}
    for pol in policies:
        with TD.use_policy(POLICIES[pol]), torch.no_grad():
            y = forward(params, cfg, {"tokens": toks}, dist, remat="none")
        out[f"fwd/{pol}"] = _np(gather_block(y, dist, S))
    if grad:
        c = torch.linspace(-1.0, 1.0, toks.numel() * cfg.padded_vocab).reshape(
            toks.shape + (cfg.padded_vocab,))
        rows, pos = block_of(dist, toks.shape[0], S)
        with TD.use_policy(TD.MXU_FP32):
            y = forward(params, cfg, {"tokens": toks}, dist, remat="block")
            y = y[..., :cfg.vocab_size]
            (y * c[rows, pos][..., :cfg.vocab_size]).sum().backward()
        out["fwd/grad"] = {k: _np(dist.mesh.all_reduce(p.grad, dist.mesh.axis_names))
                           for k, p in params.named_parameters()}
    return out


def raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def shape_checks(dist, cfg, tree, x_seq) -> dict:
    """A full expert module under a TP mesh, EP slices under TP, and EP on a
    sequence that does not split over tp: each raises ValueError."""
    full = moe_module(tree, cfg)
    ep = shard_params(moe_module(tree, cfg), cfg, dist, "ep")
    x6 = x_seq[:, :6]                                   # 6 % tp != 0 on 2x4
    sp6 = seq_sharded(dist, 6)
    return {
        "full_under_tp": raises(lambda: M.moe_block(_block(x_seq, dist, True), full, cfg,
                                                    dist, seq_sharded=True)),
        "ep_under_tp": raises(lambda: M.moe_block(_block(x_seq, dist, True), ep, cfg, dist,
                                                  seq_sharded=True)),
        "ep_unsplit_sequence": raises(lambda: M.moe_block(
            _block(x6, dist, sp6), ep, cfg, dist, moe_impl="ep", seq_sharded=sp6)),
    }


def world(dev, data: dict) -> dict:
    """Every case of one mesh shape in one world (``data["shape"]``)."""
    torch.manual_seed(0)
    shape = tuple(data["shape"])
    dist_ = Distribution(mesh=make_mesh(shape), dp_axes=("data",), tp_axis="model")
    t = {k: torch.from_numpy(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    grad, pols = data["grad"], data["policies"]
    out = {"rank": dist.get_rank()}
    out.update(moe_cases(dist_, data["moe_cfg"], data["moe"], t["x_seq"], t["x_dec"],
                         grad, pols))
    if "moe8" in data:
        out.update(ep_cases(dist_, data["moe8_cfg"], data["moe8"], t["x_seq"], grad, pols))
        # top-4: each token's four contributions, whose sum depends on their order
        out.update(ep_cases(dist_, data["moe8_k4_cfg"], data["moe8"], t["x_seq"], False,
                            ("fdp91",), tag="ep_k4"))
        out.update(mlp_cases(dist_, data["mlp_cfg"], data["mlp"], t["x_seq"], t["x_dec"],
                             pols))
        out["raises"] = shape_checks(dist_, data["moe8_cfg"], data["moe8"], t["x_seq"])
    if "llama" in data:
        out.update(forward_cases(dist_, data["llama_cfg"], data["llama"], data["tokens"],
                                 grad, pols))
    for name, (cfg, tree) in data.get("serve", {}).items():
        for profile in data["profiles"]:
            d_ = distribution_for(dist_.mesh, profile)
            params = shard_params(params_from_numpy(tree, cfg, device="cpu"), cfg, d_)
            with TD.use_policy(TD.MXU_FP32):
                toks = serve(cfg, params, torch.from_numpy(data["prompts"]), data["gen"],
                             device="cpu", dist=d_)
            out[f"serve/{name}/{profile}"] = _np(toks)
    return out


def collective_gradchecks(dev) -> dict:
    """``torch.autograd.gradcheck`` in float64 of each collective's global
    function on a 2-rank world. Every rank holds the whole input X
    (gradcheck perturbs the same element on every rank at once), enters its
    block or partial with ``shard``/``pvary``, runs the collective, and
    reassembles a replicated output with ``psum``: so the Jacobian checked
    on each rank is the global one, and each adjoint shows in it."""
    mesh = DeviceMesh((2,), ("x",))
    r = mesh.rank
    w = torch.tensor([1.5, -0.5], dtype=torch.float64)[r]      # per-rank weights

    def assemble(y, dim):
        """The replicated whole of per-rank blocks y along dim."""
        n = y.shape[dim]
        pad = [0, 0] * (y.ndim - 1 - dim) + [r * n, (1 - r) * n]
        return A.psum(torch.nn.functional.pad(y, pad), "x")

    fns = {
        "all_gather": lambda X: A.psum(w * A.all_gather(A.shard(X, "x", 0), "x", axis=0,
                                                        tiled=True), "x"),
        "all_gather_untiled": lambda X: A.psum(w * A.all_gather(A.shard(X, "x", 1), "x",
                                                                axis=0), "x"),
        "psum_scatter": lambda X: assemble(A.psum_scatter(w * A.pvary(X, "x"), "x",
                                                          scatter_dimension=1, tiled=True), 1),
        "psum": lambda X: A.psum(w * A.pvary(X, "x") ** 2, "x"),
        "shard": lambda X: assemble(w * A.shard(X, "x", 1), 1),
        "all_to_all": lambda X: assemble(A.all_to_all(w * A.shard(X, "x", 0), "x", 1, 0,
                                                      tiled=True), 0),
        "all_to_all_untiled": lambda X: assemble(A.all_to_all(
            (w * A.shard(X, "x", 0)).reshape(2, 2, 3), "x", 1, 0), 0),
    }
    out = {}
    X = torch.linspace(-1.0, 2.0, 24, dtype=torch.float64).reshape(4, 6).requires_grad_()
    with A.use_mesh(mesh):
        for name, fn in fns.items():
            out[name] = bool(torch.autograd.gradcheck(fn, (X,), raise_exception=False))
        out["axis_index"] = (A.axis_index("x"), A.axis_size("x"))
    return out
