"""Device meshes over a ``torch.distributed`` world (counterpart of
``repro.launch.mesh``).

A ``DeviceMesh`` names the axes of the world's ranks, row-major: on a mesh
of shape (R, C) over ("data", "model"), rank r sits at (r // C, r % C), so
the flattened (data, model) index of a rank is its rank, as the flattened
axes of a ``shard_map`` index its devices. The mesh holds one process group
per axis of size > 1 (the ranks that differ only along that axis). A
reduction over several axes runs as one all-reduce per axis, in the mesh's
axis order: one all-reduce over the whole world would be the same collective
for every factorization, and only the staged form makes 1x4, 2x2 and 4x1
differ in float order, as meshes differ on the reference. Integer
reductions are exact either way. A mesh whose axes all have size 1 needs no
world: its reductions are the identity, as a 1x1 mesh is on one device.

``repro_torch.parallel.axes.use_mesh(mesh)`` binds a mesh for the code it
wraps, the port's analogue of running inside ``shard_map``; ``psum``,
``pmax``, ``pmean`` and ``axis_size`` there resolve axis names against it.

``spawn(fn, world, device=...)`` starts a world of ``world`` ranks on this
host with ``torch.multiprocessing`` (the ``spawn`` start method) and a
``FileStore`` in a temporary directory, so no network is involved; each
rank runs ``fn(device, *args)`` and its return value comes back in a list
by rank. The backend follows one rule: NCCL where every rank has a card of
its own, gloo on the CPU and wherever ranks share a CUDA device (NCCL
refuses a communicator whose ranks share a device). The spawn prints its
backend. Every collective times out after ``collective_timeout`` seconds
and the whole world after ``timeout``; a rank that raises fails the spawn
with that rank's traceback.

Besides ``all_reduce``, a mesh runs the sharded model's collectives over one
named axis: ``all_gather`` (tiled), ``reduce_scatter`` (the sum, tiled),
``all_to_all`` and ``axis_index``. Gloo runs ``all_reduce``, ``broadcast``
and ``barrier`` on CUDA tensors (through host memory); whether it runs the
other three there depends on the torch build (2.11.0+cu128 runs all three
on an H100). So the first such call on a
CUDA tensor in a gloo group probes the op once, collectively (a small
tensor, its result checked, the verdict agreed over the group), and an op
the backend refuses or gets wrong is staged: its CUDA input copied to the
host, the op run on host tensors, the result copied back. World rank 0
prints each verdict once (``staged_ops()`` returns them). NCCL stages
nothing, and no op ever falls back to another collective.

No analogue: ``make_production_mesh`` builds the reference's 16x16 TPU pod
(256 chips, or two pods under a leading "pod" axis), which one host with
one or four cards does not have; ``abstract_mesh`` is a shim over the
signature changes of JAX's ``AbstractMesh``, an API the port does not use.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
import traceback
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.axes import Axes

DEFAULT_AXES = ("data", "model")


def world_size() -> int:
    """Ranks of the ``torch.distributed`` world, 1 outside one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class DeviceMesh:
    """Named axes over the ranks of the current world (module docstring).
    Building one is collective: every rank of the world builds the same
    meshes in the same order."""

    def __init__(self, shape, axis_names: Sequence[str] = DEFAULT_AXES):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do not pair up")
        n = math.prod(shape)
        if n != world_size():
            raise ValueError(f"mesh {'x'.join(map(str, shape))} wants {n} ranks, "
                             f"the world has {world_size()}")
        self.shape, self.axis_names = shape, axis_names
        self.rank = world_rank()
        grid = torch.arange(n).reshape(shape)
        self.coords = tuple(int(c) for c in (grid == self.rank).nonzero()[0])
        self._groups = {}
        for i, axis in enumerate(axis_names):
            if shape[i] == 1:
                continue
            # new_group is collective over the world: every rank creates
            # every group of the axis, in one order, and keeps its own
            for ranks in grid.movedim(i, -1).reshape(-1, shape[i]).tolist():
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = group

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def describe(self) -> str:
        return "x".join(map(str, self.shape))

    def _axes(self, axes: Axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise NameError(f"unbound axis name {a!r}: the mesh in effect has "
                                f"axes {self.axis_names}")
        return axes

    def axis_size(self, axes: Axes) -> int:
        axes = self._axes(axes)
        return math.prod(s for a, s in zip(self.axis_names, self.shape) if a in axes)

    def backends(self) -> dict:
        """axis -> the backend of this rank's group along it (size-1 axes
        have none)."""
        return {a: dist.get_backend(g) for a, g in self._groups.items()}

    def _group(self, axis: str):
        """The process group along ``axis``, None for a size-1 axis."""
        return self._groups.get(self._axes(axis)[0])

    def axis_index(self, axes: Axes) -> int:
        """This rank's coordinate along ``axes``: for several axes, the
        flattened index over them in the given order (as
        ``jax.lax.axis_index`` of a tuple)."""
        idx = 0
        for a in self._axes(axes):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in axis
        order (``jax.lax.all_gather(..., tiled=True)``)."""
        n, group = self.axis_size(axis), self._group(axis)
        if group is None:
            return x
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
        _run("all_gather", group, out, xt)
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """``x`` summed over ``axis``, this rank's block of ``dim`` (split in
        axis-size blocks) kept (``jax.lax.psum_scatter(..., tiled=True)``)."""
        n, group = self.axis_size(axis), self._group(axis)
        if group is None:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter of {x.shape[dim]} along dim {dim} over "
                             f"{n} ranks of {axis!r}")
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
        _run("reduce_scatter", group, out, xt)
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``x`` split in axis-size chunks along ``split_dim``, chunk i sent to
        the axis's rank i, the received chunks concatenated along
        ``concat_dim`` in source order (``jax.lax.all_to_all(..., tiled=True)``)."""
        n, group = self.axis_size(axis), self._group(axis)
        if group is None:
            return x
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all of {x.shape[split_dim]} along dim {split_dim} "
                             f"over {n} ranks of {axis!r}")
        xt = x.movedim(split_dim, 0).contiguous()
        out = torch.empty_like(xt)
        _run("all_to_all", group, out, xt)
        # out: n received chunks, by source, each a chunk of x along split_dim
        chunks = out.reshape((n, xt.shape[0] // n) + tuple(xt.shape[1:])).movedim(1, split_dim + 1)
        return torch.cat(list(chunks), dim=concat_dim)

    def all_reduce(self, x: torch.Tensor, axes: Axes, op: str = "sum", *,
                   inplace: bool = False) -> torch.Tensor:
        """``x`` reduced over ``axes``, one all-reduce per axis in the mesh's
        axis order. A new tensor unless ``inplace`` (then ``x``, which must
        be contiguous, is reduced where it lies)."""
        axes = self._axes(axes)
        out = x if inplace else torch.clone(x, memory_format=torch.contiguous_format)
        if not out.is_contiguous():
            raise ValueError("an in-place all-reduce needs a contiguous tensor")
        for axis in self.axis_names:
            if axis in axes and axis in self._groups:
                dist.all_reduce(out, op=_OPS[op], group=self._groups[axis])
        return out


# op -> (run on host tensors?) for CUDA tensors in gloo groups, once probed
_STAGED: dict = {}


# the single-tensor forms under their newer names where the build has them
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


def _call(op: str, group, out: torch.Tensor, inp: torch.Tensor) -> None:
    if op == "all_gather":
        _ALL_GATHER(out, inp, group=group)
    elif op == "reduce_scatter":
        _REDUCE_SCATTER(out, inp, op=dist.ReduceOp.SUM, group=group)
    else:
        dist.all_to_all_single(out, inp, group=group)


def _probe(op: str, group, device: torch.device) -> bool:
    """Whether gloo must stage ``op`` for CUDA tensors: run it once on a small
    tensor of the group's ranks and check the result. Collective over the
    group (every rank probes at the same call), the verdict agreed with an
    all-reduce on host tensors."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    inp = torch.arange(2 * n, dtype=torch.float32) + 100 * me
    if op == "all_gather":
        inp, want = inp[:2], torch.cat([torch.arange(2.0) + 100 * r for r in range(n)])
    elif op == "reduce_scatter":
        want = sum(torch.arange(2 * n, dtype=torch.float32) + 100 * r for r in range(n))
        want = want[2 * me:2 * me + 2]
    else:
        want = torch.cat([torch.arange(2.0) + 2 * me + 100 * r for r in range(n)])
    out = torch.empty_like(want, device=device)
    try:
        _call(op, group, out, inp.to(device))
        ok = torch.equal(out.cpu(), want)
    except (RuntimeError, NotImplementedError):    # a refusal, alike on every rank
        ok = False
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    staged = not bool(flag.item())
    if world_rank() == 0:
        print(f"mesh: gloo on CUDA tensors: {op} "
              + ("staged through host tensors (the backend refuses it or gets it wrong)"
                 if staged else "runs on the device tensors"), flush=True)
    return staged


def _run(op: str, group, out: torch.Tensor, inp: torch.Tensor) -> None:
    """``op`` into ``out`` (both contiguous), staged through host tensors
    where gloo refuses it on CUDA tensors (module docstring)."""
    if inp.is_cuda and dist.get_backend(group) == "gloo":
        if op not in _STAGED:
            _STAGED[op] = _probe(op, group, inp.device)
        if _STAGED[op]:
            host = torch.empty(out.shape, dtype=out.dtype)
            _call(op, group, host, inp.cpu())
            out.copy_(host)
            return
    _call(op, group, out, inp)


def staged_ops() -> dict:
    """op -> whether this process stages it for CUDA tensors in gloo groups
    (probed ops only)."""
    return dict(_STAGED)


def make_test_mesh(shape=(2, 2), axes=DEFAULT_AXES) -> DeviceMesh:
    """A mesh over the current world (of ``prod(shape)`` ranks)."""
    return DeviceMesh(shape, axes)


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# Worlds on one host
# ---------------------------------------------------------------------------
def rank_devices(device, world: int) -> list:
    """The device of each rank: every rank on ``device`` when it names one
    ("cpu", "cuda:0"); for a bare "cuda", rank r on card r when the host has
    ``world`` cards or more, else all on card 0."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        return [torch.device("cuda", r if world <= n else 0) for r in range(world)]
    return [dev] * world


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL only where every rank has a card of its own, else gloo."""
    cuda = [d for d in devices if d.type == "cuda"]
    if len(cuda) == len(devices) and len({d.index for d in cuda}) == len(devices):
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, world, devices, backend, tmp, collective_timeout):
    torch.set_num_threads(1)
    if os.path.isdir("/sys/class/net/lo"):
        # gloo connects its ranks over the loopback device, never another
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=collective_timeout))
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        result = fn(dev, *args)
    except BaseException:
        # stamped on the host's monotonic clock, before this rank leaves the
        # world: the peers' own failures (a closed connection) come later
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(f"{time.monotonic()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))


def _first_error(tmp: str, world: int):
    """(rank, traceback) of the rank that raised first, if any did."""
    errors = []
    for r in range(world):
        path = os.path.join(tmp, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                stamp, _, tb = f.read().partition("\n")
            errors.append((float(stamp), r, tb))
    return min(errors)[1:] if errors else None


def spawn(fn, world: int, *, device="cpu", args: tuple = (), timeout: float = 300.0,
          collective_timeout: float = 60.0) -> list:
    """Run ``fn(device, *args)`` on each rank of a new world of ``world``
    ranks on this host; returns the ranks' return values, by rank (module
    docstring). ``fn`` must be importable by the spawned interpreters (a
    module-level function). Raises ``TimeoutError`` when the world has not
    ended after ``timeout`` seconds, and a rank's exception, with its
    traceback, when one raises."""
    devices = rank_devices(device, world)
    backend = backend_for(devices)
    print(f"spawn: {world} ranks on {', '.join(sorted({str(d) for d in devices}))}, "
          f"backend {backend}", flush=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        # the arguments go through a file, not the start pipes: a rank reads
        # its pipe only after importing torch, so arguments past the pipe's
        # buffer would start the ranks one after another
        torch.save(args, os.path.join(tmp, "args.pt"))
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, devices, backend, tmp, collective_timeout),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0) + 0.1):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {world} ranks ({backend}) did not end "
                                       f"within {timeout:g} s")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            first = _first_error(tmp, world)
            if first is None:
                raise
            raise RuntimeError(f"rank {first[0]} of a world of {world} raised first:\n"
                               f"{first[1]}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]
