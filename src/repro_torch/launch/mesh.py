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
refuses a communicator whose ranks share a device). Gloo runs
``all_reduce``, ``broadcast`` and ``barrier`` on CUDA tensors, staged
through host memory, which is all the collectives and the data-parallel
step need. The spawn prints its backend. Every collective times out after
``collective_timeout`` seconds and the whole world after ``timeout``; a
rank that raises fails the spawn with that rank's traceback.

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
