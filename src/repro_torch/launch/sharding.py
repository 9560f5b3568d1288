"""Launch profiles, meshes and the rank's expert slices (counterpart of
the first part of ``repro.launch.sharding``): ``PROFILES``, ``parse_mesh``,
``make_mesh``, ``distribution_for``, and ``expert_take``/``shard_params``,
the ``"model"`` split of the experts that the reference's ``param_specs``
names, plus expert parallelism's split of the experts themselves.

``make_mesh`` builds a ("data", "model") ``DeviceMesh`` over the ranks of
the current ``torch.distributed`` world (one rank outside one), where the
reference builds a JAX mesh over its devices. Every other parameter stays
replicated. Waiting for ROADMAP queue 1, *Multi-device*, placement and
entry points: ``param_specs`` and the ``*_shardings`` functions, which
place parameters (the FSDP ``"data"`` split among them), caches and
batches for the FSDP, TP and SP profiles.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import DeviceMesh, world_size

PROFILES = ("fsdp", "ddp", "decode_tp")


def parse_mesh(spec: str) -> tuple:
    """Parse an ``RxC`` CLI mesh spec ("2x4" -> (2, 4); "8" -> (8, 1))."""
    parts = spec.lower().replace("×", "x").split("x")
    if len(parts) == 1:
        parts = parts + ["1"]
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise ValueError(f"bad mesh spec {spec!r}; expected RxC like 2x4")
    return int(parts[0]), int(parts[1])


def make_mesh(shape) -> DeviceMesh:
    """(data, model) mesh over the world's ranks; shape may be a
    ``parse_mesh`` tuple or an ``RxC`` string."""
    if isinstance(shape, str):
        shape = parse_mesh(shape)
    r, c = shape
    n = world_size()
    if r * c != n:
        raise ValueError(f"mesh {r}x{c} wants {r * c} devices, have {n}")
    return DeviceMesh((r, c), ("data", "model"))


def distribution_for(mesh, profile: str = "fsdp", numerics_policy=None):
    """The Distribution a launch profile runs the model under, with the
    deployed plan's NumericsPolicy riding along."""
    from repro_torch.models.layers import Distribution
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; one of {PROFILES}")
    return Distribution(mesh=mesh, dp_axes=("data",), tp_axis="model",
                        joint_tp=profile == "decode_tp",
                        numerics_policy=numerics_policy)


def expert_take(cfg, dist, moe_impl: str = "tp"):
    """``take(name, t)``: the rank's slice of a full expert tensor ``t``
    (``w_in``/``w_gate`` (E, d, f), ``w_out`` (E, f, d)) for ``dist`` and
    ``moe_impl``: for TP the rank's f / n columns (rows of ``w_out``), n =
    tp or, under ``joint_tp``, the joint (dp..., tp) size in the flattened
    rank order; for EP its E / tp whole experts. A view; ``init`` and
    ``shard_params`` copy it."""
    from repro_torch.models.moe import expert_split, joint_axes
    E, f = expert_split(cfg, dist, moe_impl)
    mesh = dist.mesh
    if moe_impl == "ep":
        i = mesh.axis_index(dist.tp_axis)
        return lambda name, t: t.narrow(0, i * E, E)
    i = (mesh.axis_index(joint_axes(dist)) if dist.joint_tp
         else mesh.axis_index(dist.tp_axis) if dist.tp > 1 else 0)
    return lambda name, t: t.narrow(2 if name in ("w_in", "w_gate") else 1, i * f, f)


def shard_params(params: torch.nn.Module, cfg, dist, moe_impl: str = "tp"):
    """``params`` (a full ``Transformer`` or ``MoE``) with every expert
    tensor replaced by the rank's slice (``expert_take``), in place; returns
    it. The other parameters stay replicated."""
    from repro_torch.models.moe import MoE
    if dist.mesh is None:
        return params
    take = expert_take(cfg, dist, moe_impl)
    mods = [params] if isinstance(params, MoE) else \
        [m for m in params.modules() if isinstance(m, MoE)]
    with torch.no_grad():
        for m in mods:
            for name in ("w_in", "w_gate", "w_out"):
                full = getattr(m, name)
                setattr(m, name, torch.nn.Parameter(take(name, full.detach()).clone(),
                                                    requires_grad=full.requires_grad))
    return params
