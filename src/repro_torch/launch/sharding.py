"""Launch profiles, meshes and parameter placement (counterpart of the
first part of ``repro.launch.sharding``): ``PROFILES``, ``parse_mesh``,
``make_mesh``, ``distribution_for``, the reference's placement rules
(``param_specs``, ``param_shardings``) and ``expert_take``/``shard_params``,
the rank's expert slices that the sharded MoE consumes, plus expert
parallelism's split of the experts themselves.

``make_mesh`` builds a ("data", "model") ``DeviceMesh`` over the ranks of
the current ``torch.distributed`` world (one rank outside one), where the
reference builds a JAX mesh over its devices.

Placement. ``param_specs(cfg, params, profile, mesh)`` gives every
parameter the reference's spec of the same leaf (``_leaf_spec`` for
``fsdp``, ``_leaf_spec_ddp``, ``_leaf_spec_decode_tp``, their rules as
they are), the stacked layer dims (``_lead_of``) taken off: the reference
stacks its layers on leading axes, the port holds one module a layer
(``models.convert.reference_path`` maps the names). A spec has one entry a
dim: ``None``, an axis name, or a tuple of axis names (a joint axis). The
mesh is a ``DeviceMesh`` or a plain ``{axis: size}`` mapping.
``param_shardings`` turns the specs into ``parallel.placement.Placement``s
(each rank's block, the global shape, the bytes a rank holds) and refuses a
dim that does not split evenly, as the reference's ``device_put`` does.
``place`` cuts a model's parameters to the rank's blocks in place; ``init(...,
profile=)`` cuts each unit's host draw before it moves to the device. The
model then gathers each unit's leaves just before the unit runs
(``parallel.placement.gathered``) and reads them as the sharded forward
reads replicated weights, so a placed serve computes what the replicated
sharded serve computes, bit for bit.

The expert tensors read the rank's slice of ``expert_take`` (``moe_impl``
"tp", the serve's): under ``fsdp`` their spec splits that slice's dim over
"model" as the take does and ``d`` over "data", so a unit gathers them over
"data" only; under ``decode_tp`` ``w_in``/``w_gate`` are placed as the
joint take, while ``w_out``'s spec splits ``d`` over the joint axis (the
reference's rule: the last dim first), so its unit gathers it whole and
keeps the take's ``f`` slice; under ``ddp`` they are replicated and cut on
use.

Waiting for ROADMAP queue 1, *Multi-device*, placement and entry points:
``opt_state_shardings``, ``batch_shardings`` and ``cache_shardings``.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import DeviceMesh, world_size
from repro_torch.parallel.placement import Placement, attach, axis_sizes

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


# ---------------------------------------------------------------------------
# Placement: the reference's rules, leaf by leaf
# ---------------------------------------------------------------------------
def _pad(spec: tuple, ndim: int, lead: int) -> tuple:
    spec = (None,) * lead + tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _leaf_spec(path: str, ndim: int, extra_lead: int) -> tuple:
    """The fsdp spec of a reference leaf; ``extra_lead`` = its stacked
    layer dims (1 for scanned layers, 2 for hybrid groups), left whole."""
    pad = lambda spec: _pad(spec, ndim, extra_lead)
    name = path.split("/")[-1]
    # --- non-layer params (extra_lead == 0) -------------------------------
    if name == "embed":
        return ("model", "data")
    if name == "lm_head":
        return ("data", "model")
    # --- norms / scalars / biases ------------------------------------------
    if "norm" in name or name in ("A_log", "D", "dt_bias", "bq", "bk", "bv"):
        if name == "norm" and ndim - extra_lead == 1:
            return pad(("model",) if _is_ssm_norm(path) else (None,))
        return pad((None,) * (ndim - extra_lead))
    # --- attention ----------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        return pad(("data", None))
    if name == "wo":
        return pad((None, "data"))
    # --- dense MLP -----------------------------------------------------------
    if name in ("w_in", "w_gate") and ndim - extra_lead == 2:
        return pad(("data", "model"))
    if name == "w_out" and ndim - extra_lead == 2:
        return pad(("model", "data"))
    # --- MoE ------------------------------------------------------------------
    if name == "router":
        return pad(("data", None))
    if name in ("w_in", "w_gate") and ndim - extra_lead == 3:
        return pad((None, "data", "model"))
    if name == "w_out" and ndim - extra_lead == 3:
        return pad((None, "model", "data"))
    # --- SSM -------------------------------------------------------------------
    if name in ("in_x", "in_z"):
        return pad(("data", "model"))
    if name in ("in_B", "in_C", "in_dt"):
        return pad(("data", None))
    if name == "conv_x":
        return pad((None, "model"))
    if name in ("conv_B", "conv_C"):
        return pad((None, None))
    if name == "out":
        return pad(("model", "data"))
    return pad((None,) * (ndim - extra_lead))


def _is_ssm_norm(path: str) -> bool:
    return path.endswith("ssm/norm")


def _lead_of(path: str, cfg) -> int:
    """How many stacked leading dims a reference leaf has."""
    parts = path.split("/")
    if parts[0] in ("layers", "enc_layers", "dec_layers"):
        return 2 if (cfg.family == "hybrid" and parts[0] == "layers") else 1
    return 0


def _leaf_spec_ddp(path: str, ndim: int, lead: int) -> tuple:
    name = path.split("/")[-1]
    if name == "embed":
        return ("model", None)
    if name == "lm_head":
        return (None, "model")
    return (None,) * ndim


def _leaf_spec_decode_tp(path: str, shape: tuple, lead: int, sizes: dict) -> tuple:
    name = path.split("/")[-1]
    joint = tuple(sizes)                              # all axes combined
    n_joint = 1
    for a in joint:
        n_joint *= sizes[a]
    spec = [None] * len(shape)
    if name in ("embed", "lm_head"):
        v_dim = 0 if name == "embed" else 1
        if shape[v_dim] % n_joint == 0:
            spec[v_dim] = joint
        else:
            spec[v_dim] = "model"
        return tuple(spec)
    if len(shape) - lead < 2:                         # norms/bias/scalars
        return tuple(spec)
    # prefer col-parallel on the last dim, else row-parallel, else model-only
    for dims, axes in (((-1,), joint), ((-2,), joint),
                       ((-1,), "model"), ((-2,), "model")):
        d = dims[0]
        n = n_joint if axes == joint else sizes["model"]
        if shape[d] % n == 0:
            spec[d] = axes
            return tuple(spec)
    return tuple(spec)


def param_specs(cfg, params, profile: str = "fsdp", mesh=None) -> dict:
    """{parameter name: spec} for a ``Transformer`` (``init_abstract``'s
    will do) under a profile (module docstring):

      fsdp      — ZeRO-3: weights split over data (largest axis) + TP over
                  model; gathered per unit on use.
      ddp       — weights replicated (embed/lm_head stay vocab-TP).
      decode_tp — every projection split over the JOINT (data, model) axes
                  on a divisible dim (the reference reads them in place; the
                  port gathers them per unit).

    ``mesh`` (a ``DeviceMesh`` or {axis: size}) is needed by decode_tp."""
    from repro_torch.models.convert import reference_path
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; one of {PROFILES}")
    if profile == "decode_tp" and mesh is None:
        raise ValueError("the decode_tp profile needs the mesh's axis sizes")
    sizes = None if mesh is None else axis_sizes(mesh)
    out = {}
    for name, leaf in params.named_parameters():
        path, lead_shape = reference_path(name, cfg)
        lead = _lead_of(path, cfg)
        if lead != len(lead_shape):
            raise ValueError(f"{name}: {len(lead_shape)} stacked dims, the rules say {lead}")
        shape = tuple(lead_shape) + tuple(leaf.shape)
        if profile == "ddp":
            spec = _leaf_spec_ddp(path, len(shape), lead)
        elif profile == "decode_tp":
            spec = _leaf_spec_decode_tp(path, shape, lead, sizes)
        else:
            spec = _leaf_spec(path, len(shape), lead)
        if any(e is not None for e in spec[:lead]):
            raise ValueError(f"{name}: the spec {spec} splits a stacked layer dim")
        out[name] = tuple(spec[lead:])
    return out


EXPERTS = ("w_in", "w_gate", "w_out")


def _expert_use(name: str, sizes: dict, profile: str):
    """The layout the sharded MoE reads of an expert tensor (``expert_take``
    for ``moe_impl`` "tp" under ``distribution_for(mesh, profile)``), None
    for any other leaf."""
    parts = name.split(".")
    if len(parts) < 2 or parts[-2] != "moe" or parts[-1] not in EXPERTS:
        return None
    axes = tuple(sizes) if profile == "decode_tp" else "model"
    use = [None, None, None]
    use[2 if parts[-1] != "w_out" else 1] = axes
    return tuple(use)


def param_shardings(cfg, params, mesh, profile: str = "fsdp") -> dict:
    """{parameter name: ``Placement``} of ``param_specs`` on ``mesh`` (a
    ``DeviceMesh``, or {axis: size} for the layout alone). Raises
    ValueError, naming the leaf, where a dim does not split evenly."""
    specs = param_specs(cfg, params, profile, mesh)
    sizes = axis_sizes(mesh)
    out = {}
    for name, leaf in params.named_parameters():
        try:
            out[name] = Placement(mesh, specs[name], tuple(leaf.shape),
                                  _expert_use(name, sizes, profile))
        except ValueError as e:
            raise ValueError(f"{name} under {profile} on "
                             f"{'x'.join(map(str, sizes.values()))}: {e}") from None
    return out


def check_placeable(cfg, dist, profile: str) -> None:
    """Raise unless ``dist`` runs ``profile``'s placement: a mesh, the
    profile's ``joint_tp``, and a family whose sharded forward is ported
    (dense, moe)."""
    if dist.mesh is None:
        raise ValueError("placement needs a Distribution with a mesh")
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; one of {PROFILES}")
    if dist.joint_tp != (profile == "decode_tp"):
        raise ValueError(f"profile {profile!r} with joint_tp={dist.joint_tp}: build the "
                         f"Distribution with distribution_for(mesh, {profile!r})")
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: placement serves the dense and moe families; the "
            f"{cfg.family} family on a mesh is not ported yet")


def _block_param(p: torch.nn.Parameter, pl: Placement, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(pl.block(p.detach()).contiguous().to(device),
                              requires_grad=p.requires_grad)


def _cut_to_blocks(unit: torch.nn.Module, prefix: str, shardings: dict, device=None) -> None:
    """Replace every parameter of ``unit`` (named ``prefix + local name`` in
    ``shardings``) by the rank's block, on ``device`` (its own if None)."""
    with torch.no_grad():
        for local, p in list(unit.named_parameters()):
            *path, leaf = local.split(".")
            setattr(unit.get_submodule(".".join(path)), leaf,
                    _block_param(p, shardings[prefix + local], device or p.device))


def place(params: torch.nn.Module, cfg, dist, profile: str = "fsdp") -> torch.nn.Module:
    """``params`` (a full ``Transformer``) with every parameter replaced by
    the rank's block of ``param_shardings(cfg, params, dist.mesh,
    profile)``, in place, and the placements attached
    (``parallel.placement.attach``); returns it."""
    check_placeable(cfg, dist, profile)
    shardings = param_shardings(cfg, params, dist.mesh, profile)
    _cut_to_blocks(params, "", shardings)
    return attach(params, shardings)


def placer(cfg, dist, profile: str, device):
    """``place(name, unit)`` for ``Transformer(..., place=)``: the unit (a
    parameter, or a module whose parameters are named ``name.<local>``),
    drawn whole on the host, cut to the rank's blocks and moved to
    ``device``; and the shardings, to ``attach`` once the model is built."""
    from repro_torch.models.transformer import init_abstract
    check_placeable(cfg, dist, profile)
    shardings = param_shardings(cfg, init_abstract(cfg), dist.mesh, profile)

    def cut(name, unit):
        if isinstance(unit, torch.nn.Parameter):
            return _block_param(unit, shardings[name], device)
        _cut_to_blocks(unit, name + ".", shardings, device)
        return unit

    return cut, shardings
