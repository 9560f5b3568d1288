"""Named-axis collectives of a bound mesh (the port's analogue of running
inside ``shard_map``: ``jax.lax.psum``/``pmax``/``pmean`` and
``repro.parallel.compat.axis_size``).

``use_mesh(mesh)`` binds a mesh (a ``launch.mesh.DeviceMesh``) for the code
it wraps: ``psum``, ``pmax``, ``pmean``, ``axis_size`` and
``gemm(..., reduce_axis=...)`` resolve axis names (a name or a tuple of
names) against it, and raise ``NameError`` for a name it does not have or
when no mesh is bound. The binding is one per process (a rank is a
process), not per thread, so the autograd thread sees it too. The mesh
runs the reduction itself (one all-reduce per axis, in its axis order), so
this module needs no process group and imports no ``torch.distributed``.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Union

import torch

Axes = Union[str, Sequence[str]]

_BOUND: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind ``mesh`` for the code this wraps (module docstring)."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def _bound(axes: Axes):
    if not _BOUND:
        raise NameError(f"unbound axis name {axes!r}: no mesh is in effect "
                        "(reduce inside `with use_mesh(mesh)`)")
    return _BOUND[-1]


def psum(x: torch.Tensor, axes: Axes, *, inplace: bool = False) -> torch.Tensor:
    """``x`` summed over ``axes`` of the bound mesh (exact for integers;
    int32 wraps in two's complement, as ``jax.lax.psum`` does)."""
    return _bound(axes).all_reduce(x, axes, "sum", inplace=inplace)


def pmax(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return _bound(axes).all_reduce(x, axes, "max")


def pmean(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return psum(x, axes) / axis_size(axes)


def axis_size(axes: Axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names) of the bound mesh."""
    return _bound(axes).axis_size(axes)
