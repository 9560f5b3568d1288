"""Launch profiles and meshes (counterpart of the first part of
``repro.launch.sharding``): ``PROFILES``, ``parse_mesh``, ``make_mesh``
and ``distribution_for``.

``make_mesh`` builds a ("data", "model") ``DeviceMesh`` over the ranks of
the current ``torch.distributed`` world (one rank outside one), where the
reference builds a JAX mesh over its devices. Waiting for the sharded model
(ROADMAP queue 1, *Multi-device*, the sharded model): ``param_specs`` and
the ``*_shardings`` functions, which place parameters, caches and batches
for the FSDP, TP and SP profiles.
"""

from __future__ import annotations

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
