"""Placed parameters: each rank holds its block of a weight and gathers the
whole just before a unit of the model reads it.

A ``Placement`` is one leaf's layout on a mesh: its global shape and a spec,
one entry a dim, each ``None`` (whole on every rank), an axis name, or a
tuple of axis names (a joint axis: the dim split over the flattened index of
those axes, row-major, as ``DeviceMesh`` lays out ranks). The mesh is a
``launch.mesh.DeviceMesh`` or a plain ``{axis: size}`` mapping; with a
mapping the layout is pure arithmetic (``block(full, coords)`` of any mesh
position), with a ``DeviceMesh`` the rank's own position is the default and
``gather`` runs the collectives. ``launch.sharding.param_shardings`` builds
them from the reference's specs, ``launch.sharding.place`` cuts a model's
parameters to them.

``use`` is the layout the model code reads: the whole tensor (every entry
``None``), or for an expert tensor the rank's slice that the sharded MoE
consumes (``launch.sharding.expert_take``). ``gather`` turns a block into
that layout: every dim whose entry differs is all-gathered over its axes
(the differentiable ``parallel.axes.all_gather``, one axis at a time, the
last axis of a joint entry first, so the blocks land in flattened order;
each gather stacks the blocks and merges them into the dim, contiguous),
then cut to the ``use`` block where that one is split. A dim already split
as ``use`` wants it moves no data. A CUDA block in a gloo mesh is gathered
as a host copy and the whole leaf moved to the card once: gloo runs a CUDA
tensor's collective through host memory anyway, and so the card holds only
the rank's block and the leaf it reads, not the collectives' intermediates
(the stacked blocks, and the half-gathered leaf of a joint or two-dim
split).

The model gathers per unit (``gathered``): a decoder block, the embedding,
``final_norm`` with the head. ``attach`` records each placed parameter's
placement on the module that owns it and marks every module above one;
``gathered(module)`` then returns a read-only view of the module with its
placed parameters gathered, in the same order on every rank, and a module
with none placed unchanged. No collective runs behind a plain attribute
read: the view is built once, at the start of the unit, and freed with it.

``STATS`` counts what the gathers do in this process: calls, the bytes they
make, the bytes received from other ranks, host seconds, and the gathered
bytes alive at once (each tracked until the tensor is freed) with their
peak.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref

import torch
from torch import nn

from repro_torch.parallel.axes import all_gather, use_mesh


def axis_sizes(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh`` (in its axis order) or of a mapping."""
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(mesh)


def entry_axes(entry) -> tuple:
    """The axes of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One leaf on a mesh (module docstring)."""

    mesh: object
    spec: tuple
    shape: tuple
    use: tuple = None                     # None: the whole tensor

    def __post_init__(self):
        if self.use is None:
            object.__setattr__(self, "use", (None,) * len(self.shape))
        for spec in (self.spec, self.use):
            if len(spec) != len(self.shape):
                raise ValueError(f"spec {spec} for a leaf of shape {self.shape}")
            for d, entry in enumerate(spec):
                n = self.ranks(entry)
                if self.shape[d] % n:
                    raise ValueError(f"dim {d} of {self.shape} does not split over "
                                     f"{entry_axes(entry)} ({n} ranks)")

    def ranks(self, entry) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in entry_axes(entry))

    def _coords(self, coords) -> dict:
        return dict(zip(axis_sizes(self.mesh), self.mesh.coords if coords is None else coords))

    def _index(self, entry, coords: dict) -> int:
        sizes, idx = axis_sizes(self.mesh), 0
        for a in entry_axes(entry):
            idx = idx * sizes[a] + coords[a]
        return idx

    @property
    def local_shape(self) -> tuple:
        return tuple(s // self.ranks(e) for s, e in zip(self.shape, self.spec))

    def nbytes(self, dtype=torch.float32) -> int:
        """Bytes a rank holds of this leaf."""
        return math.prod(self.local_shape) * torch.empty((), dtype=dtype).element_size()

    def _cut(self, t: torch.Tensor, spec, coords) -> torch.Tensor:
        if all(e is None for e in spec):
            return t
        coords = self._coords(coords)
        for d, entry in enumerate(spec):
            if entry is not None:
                k = t.shape[d] // self.ranks(entry)
                t = t.narrow(d, self._index(entry, coords) * k, k)
        return t

    def block(self, full: torch.Tensor, coords=None) -> torch.Tensor:
        """The block of ``full`` (the global tensor) at mesh position
        ``coords`` (a tuple in axis order; the rank's own by default): a
        view."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"a tensor of {tuple(full.shape)} for a leaf of {self.shape}")
        return self._cut(full, self.spec, coords)

    def _moving(self) -> list:
        """(dim, axes) of every dim ``gather`` all-gathers: split otherwise
        than ``use`` wants, over more than one rank."""
        return [(d, entry_axes(e)) for d, (e, u) in enumerate(zip(self.spec, self.use))
                if entry_axes(e) != entry_axes(u) and self.ranks(e) > 1]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The rank's block ``local`` in the ``use`` layout (module
        docstring), contiguous as a parameter is: a tensor's strides pick
        the GEMM's code path, and so its bits. ``local`` itself when
        nothing moves and nothing is cut."""
        moving, out, received = self._moving(), local, 0
        t0 = time.perf_counter()
        if moving:
            if local.is_cuda and "gloo" in self.mesh.backends().values():
                out = local.to("cpu")          # module docstring
            with use_mesh(self.mesh):
                for d, axes in moving:
                    for axis in reversed(axes):
                        # the blocks stacked on a new leading dim, then merged
                        # into dim d: a copy of whole rows, not a transpose
                        part = out
                        out = all_gather(part, axis).movedim(0, d)
                        out = out.reshape(part.shape[:d] + (-1,) + part.shape[d + 1:])
                        received += _nbytes(out) - _nbytes(part)
        # every dim split otherwise than ``use`` wants is whole now
        out = self._cut(out, [u if entry_axes(e) != entry_axes(u) else None
                              for e, u in zip(self.spec, self.use)], None)
        out = out.contiguous().to(local.device)
        if moving:
            STATS.made(out, received, time.perf_counter() - t0)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class GatherStats:
    """What the gathers of this process did since ``reset`` (module
    docstring)."""

    def __init__(self):
        self.live = 0
        self.reset()

    def reset(self) -> None:
        """Zero the counters; ``live`` stays what is alive now, the peak
        starts from it."""
        self.calls, self.bytes, self.received, self.seconds = 0, 0, 0, 0.0
        self.peak_live = self.live

    def made(self, out: torch.Tensor, received: int, seconds: float) -> None:
        """Count one gathered leaf ``out``, of which ``received`` bytes came
        from other ranks, in ``seconds``; track it until it is freed."""
        n = _nbytes(out)
        self.calls += 1
        self.bytes += n
        self.received += received
        self.seconds += seconds
        self.live += n
        self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(out, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def snapshot(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "received": self.received,
                "seconds": self.seconds, "live": self.live, "peak_live": self.peak_live}


STATS = GatherStats()


def attach(model: nn.Module, placements: dict) -> nn.Module:
    """Record ``placements`` ({parameter name: Placement}) on the modules
    that own the parameters (``module.placements``, by local name) and mark
    every module above one (``module.placed``). Returns ``model``."""
    for name, pl in placements.items():
        *path, leaf = name.split(".")
        mod = model
        mod.placed = True
        for part in path:
            mod = getattr(mod, part)
            mod.placed = True
        if not hasattr(mod, "placements"):
            mod.placements = {}
        mod.placements[leaf] = pl
    return model


def placed_bytes(model: nn.Module) -> int:
    """Bytes of the parameters the module holds (on this rank)."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


class _Gathered:
    """A module's parameters as the model reads them (``gathered``); every
    other attribute is the module's."""

    def __init__(self, module: nn.Module, values: dict):
        self._module = module
        self.__dict__.update(values)

    def __getattr__(self, name):
        return getattr(self._module, name)


def gathered(module: nn.Module, names=None):
    """``module`` with its placed parameters gathered (module docstring):
    ``names`` limits it to those direct parameters. A module with none
    placed comes back as it is."""
    if not getattr(module, "placed", False):
        return module
    own = getattr(module, "placements", {})
    values = {}
    for name, p in module.named_parameters(recurse=False):
        if names is None or name in names:
            values[name] = own[name].gather(p) if name in own else p
    if names is None:
        for name, child in module.named_children():
            if getattr(child, "placed", False):
                values[name] = gathered(child)
    return _Gathered(module, values)
