"""Named-axis collectives of a bound mesh (the port's analogue of running
inside ``shard_map``: ``jax.lax.psum``/``pmax``/``pmean``, ``all_gather``,
``psum_scatter``, ``all_to_all``, ``axis_index`` and
``repro.parallel.compat.axis_size``).

``use_mesh(mesh)`` binds a mesh (a ``launch.mesh.DeviceMesh``) for the code
it wraps: ``psum``, ``pmax``, ``pmean``, ``axis_size`` and
``gemm(..., reduce_axis=...)`` resolve axis names (a name or a tuple of
names) against it, and raise ``NameError`` for a name it does not have or
when no mesh is bound. The binding is one per process (a rank is a
process), not per thread, so the autograd thread sees it too. The mesh
runs the reduction itself (one all-reduce per axis, in its axis order), so
this module needs no process group and imports no ``torch.distributed``.

Gradients. Every collective here is a ``torch.autograd.Function`` whose
backward is its adjoint, so a sharded forward differentiates like the
single-device one. A rank's tensor is either its block of a global tensor,
a per-rank partial (the global tensor is the sum over the axis), or
replicated (every rank holds the whole). A replicated activation carries the
whole gradient on every rank; a block carries its block's. The adjoints:

- ``all_gather`` (blocks to the whole, used by per-rank work) <->
  ``psum_scatter`` (partials to blocks): each is the other's backward;
- ``psum`` (partials to replicated): the replicated gradient passes through
  to every partial;
- ``shard`` (replicated to this rank's block): its backward all-gathers the
  blocks' gradients into the whole;
- ``pvary`` (a replicated value entering per-rank work, the identity): its
  backward sums the per-rank gradients (``jax.lax.pvary``);
- ``all_to_all``: its backward is the inverse all-to-all.

Weights are not entered with ``pvary``: a rank's gradient of a replicated
weight is its own share, and the sum of the shares over the ranks that hold
the weight is its gradient (data parallelism reduces them so). A share is
whole wherever the ranks along an axis repeat the same work (activations
replicated over it), so there sum over the axes that split the data only.
The in-place ``psum`` is not differentiable.
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


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes, "sum"), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = mesh.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"shard of {x.shape[dim]} along dim {dim} over {n} ranks "
                             f"of {axis!r}")
        k = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axis) * k, k).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.mesh.all_to_all(g, ctx.axis, concat_dim, split_dim), None, None, None, None


def psum(x: torch.Tensor, axes: Axes, *, inplace: bool = False) -> torch.Tensor:
    """``x`` summed over ``axes`` of the bound mesh (exact for integers;
    int32 wraps in two's complement, as ``jax.lax.psum`` does). Its backward
    passes the replicated gradient to every partial (module docstring);
    ``inplace`` reduces ``x`` where it lies and is not differentiable."""
    mesh = _bound(axes)
    if inplace:
        return mesh.all_reduce(x, axes, "sum", inplace=True)
    return _Psum.apply(x, mesh, axes)


def pvary(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """``x``, replicated over ``axes``, entering per-rank work: the identity,
    whose backward sums the ranks' gradients over ``axes``."""
    return _Pvary.apply(x, _bound(axes), axes)


def _one_axis(axis_name) -> str:
    if not isinstance(axis_name, str):
        raise NotImplementedError(f"{axis_name!r}: one named axis, not a tuple")
    return axis_name


def all_gather(x: torch.Tensor, axis_name: str, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """The ranks' ``x`` along ``axis_name`` (``jax.lax.all_gather``): stacked
    on a new dim ``axis``, or concatenated along ``axis`` when ``tiled``.
    Its backward is ``psum_scatter``."""
    mesh, axis_name = _bound(axis_name), _one_axis(axis_name)
    if not tiled:
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, mesh, axis_name, axis)


def psum_scatter(x: torch.Tensor, axis_name: str, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """``x`` summed over ``axis_name``, this rank's block of
    ``scatter_dimension`` kept (``jax.lax.psum_scatter``); without ``tiled``
    that dim has the axis's size and is dropped. Its backward all-gathers."""
    mesh, axis_name = _bound(axis_name), _one_axis(axis_name)
    if not tiled and x.shape[scatter_dimension] != mesh.axis_size(axis_name):
        raise ValueError(f"psum_scatter: dim {scatter_dimension} has "
                         f"{x.shape[scatter_dimension]}, the axis {mesh.axis_size(axis_name)}")
    y = _ReduceScatter.apply(x, mesh, axis_name, scatter_dimension)
    return y if tiled else y.squeeze(scatter_dimension)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int, concat_axis: int, *,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all``: ``split_axis`` split in axis-size chunks, chunk
    i to rank i, the received chunks concatenated along ``concat_axis`` by
    source (``tiled``); without ``tiled`` ``split_axis`` has the axis's size
    and moves, indexing the source, to ``concat_axis``. Its backward is the
    inverse all-to-all."""
    mesh, axis_name = _bound(axis_name), _one_axis(axis_name)
    if tiled:
        return _AllToAll.apply(x, mesh, axis_name, split_axis, concat_axis)
    if x.shape[split_axis] != mesh.axis_size(axis_name):
        raise ValueError(f"all_to_all: dim {split_axis} has {x.shape[split_axis]}, "
                         f"the axis {mesh.axis_size(axis_name)}")
    y = _AllToAll.apply(x, mesh, axis_name, split_axis, split_axis)
    return y.movedim(split_axis, concat_axis)


def shard(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (replicated over ``axis_name``) along
    ``dim``; its backward all-gathers the blocks' gradients."""
    return _Shard.apply(x, _bound(axis_name), _one_axis(axis_name), dim)


def axis_index(axes: Axes) -> int:
    """This rank's index along ``axes`` of the bound mesh (flattened over a
    tuple, in its order), as ``jax.lax.axis_index``."""
    return _bound(axes).axis_index(axes)


def pmax(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return _bound(axes).all_reduce(x, axes, "max")


def pmean(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    return psum(x, axes) / axis_size(axes)


def axis_size(axes: Axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names) of the bound mesh."""
    return _bound(axes).axis_size(axes)
