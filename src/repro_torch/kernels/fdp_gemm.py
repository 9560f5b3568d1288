"""The exact <ovf,msb,lsb> FDP GEMM kernels, hand-written for Hopper.

``fdp_gemm(a, b, spec=..., fmt=...)`` computes ``(B, M, K) @ (B, K, N) ->
(B, M, N)`` f32 with every product entered exactly into a fixed-point
register and one rounding per output. It replaces the Pallas body
``repro/kernels/fdp_gemm.py:fdp_gemm_kernel``, reached there through
``fdp_gemm_pallas_batched`` (every N-D call) and ``fdp_gemm_pallas`` (2-D
calls, which here are the batched call with B = 1).

``fdp_gemm_looped(a, b, plan, spec=..., fmt=...)`` is the same function,
2-D, computed in the seed's order: one thread per output walks k in order
and normalizes carries once per ``plan.bk`` products. It replaces the
Pallas body ``fdp_gemm_kernel_looped`` (``fdp_gemm_pallas(impl="loop")``),
the baseline the vectorized engine is measured against.

``fdp_ragged_gemm(x, w, group_sizes, spec=..., fmt=...)`` is the
sorted-segment MoE forward: ``x (T, d)`` rows sorted by group, ``w (E, d,
f)``, ``group_sizes (E,)`` -> ``(T, f)`` f32, row ``t`` against the weights
of its group, rows past ``sum(group_sizes)`` zero. It replaces the Pallas
body ``fdp_ragged_kernel`` (through ``fdp_ragged_gemm_pallas``). Each block
of the kernel finds its tile of one group's rows from the group sizes on
the device, so no tile table is built and the host never reads the sizes.

``fdp_ragged_dw(x, g, group_sizes, spec=..., fmt=...)`` is the
sorted-segment MoE weight gradient: ``x (T, d)``, ``g (T, f)`` rows sorted by
group -> ``dW (E, d, f)`` f32, ``dW[e] = x[rows of e]ᵀ @ g[rows of e]``, exact
zeros for a zero-size group. It replaces the Pallas body
``fdp_ragged_dw_kernel`` (through ``fdp_ragged_dw_pallas``); each block
finds its group's row window from the group sizes on the device.

What bounds all four on the card: int32 CUDA-core operations per exact product
(form the 48-bit significand product, align it to the grid, add it into the
register), not bytes and not the tensor cores, which have no exact
wide-integer accumulate. ``int32_ops`` counts what the function needs,
whatever the design; ``chip_smoke.py`` turns that count into the bound it
reports.

The dense kernel (``csrc/fdp_gemm.cu``) spends close to that count. A block
decodes each operand element of its tiles once into shared memory; each
thread owns several outputs (4 x 2 up to 8 limbs, fewer rows where the call
has fewer), so a decoded element serves several products; the register is
a two's-complement integer of 32-bit words (``DENSE_CAPACITIES``: 2 to 40
limbs, so a narrow register costs less), and a product enters it with two
shifts a word and one add-with-carry chain, with no carry pending at any
time. ``dense_launch`` picks the capacity, the rows a thread owns, the
thread layout and the K split, the least costly by a model fitted to the
kernel's device times (``dense_cost``), unless the call's plan names a
launch measured on the card (``core.dispatch.plan_gemm(autotune=True)``,
the zoo of ``core.schedules``); ``dense_plan`` folds a weight
broadcast over the batch into the rows (``fold_broadcast``) so that it is
read once. The tile table is ``csrc/fdp_gemm_tiles.def``, which the kernels
include and ``dense_launch`` reads.

The sorted-segment forward (``csrc/fdp_ragged_gemm.cu``) runs the same tile
body (``csrc/fdp_tile.cuh``) on tiles of one group's rows against that
group's weights, found on the device; ``ragged_launch`` picks its layout
from the shapes alone, as the dense layout for E groups of T/E rows. The
weight gradient (``csrc/fdp_ragged_dw.cu``) runs it too, a block on one
group's window: ``dW[e]`` is the dense ``x_eᵀ @ g_e`` of depth ``n_e``,
whose last chunk stops at the group's last row; ``ragged_dw_launch`` picks
its layout as the dense layout for E groups (the batch) of d rows and f
columns, T/E deep.

The seed-order kernel still spends more operations than the function
needs, on purpose: it keeps the seed's per-k order, one thread per output,
with the limb register of ``csrc/fdp_common.cuh``.

On CPU tensors the wrappers run the plain PyTorch versions
(``fdp_gemm_plain``, ``fdp_ragged_gemm_plain``, ``fdp_ragged_dw_plain``: the
port's ``simulate`` mode; ``fdp_gemm_looped`` runs ``core.fdp.fdp_gemm``); on
CUDA tensors they launch the kernel or raise. Each source in
``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` at first use, all at
once, into a shared library in ``_build/`` beside this file (git ignores
it), and bound through ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import heapq
import math
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core import fdp as core_fdp
from repro_torch.core.accumulator import SAFE_CHUNK, AccumulatorSpec
from repro_torch.core.formats import PositFormat

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")
MAX_LIMBS = 40          # the widest instantiation of every kernel


def _dense_table() -> tuple:
    """The dense kernel's table, read from its one copy,
    ``csrc/fdp_gemm_tiles.def`` (which the kernel includes): ``({capacity:
    (most rows, columns) of outputs a thread owns}, {capacity: blocks a
    multiprocessor holds at once}, shared-memory limit in bytes)``."""
    text = (_CSRC / "fdp_gemm_tiles.def").read_text()
    rows = [tuple(map(int, m)) for m in re.findall(
        r"^FDP_DENSE_TILE\(\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+)\)", text, re.M)]
    limit = re.search(r"^FDP_DENSE_SMEM_LIMIT\((\d+)\)", text, re.M)
    return ({lc: (tm, tn) for lc, tm, tn, _ in rows},
            {lc: blocks for lc, _, _, blocks in rows}, int(limit.group(1)))


# The dense kernel (csrc/fdp_gemm.cu): its register capacities in limbs; at
# each capacity the most rows and the columns of outputs a thread owns and
# the blocks a multiprocessor holds at once; the shared memory a block may
# take. 256 threads a block.
DENSE_TILE, DENSE_RESIDENT, DENSE_SMEM_LIMIT = _dense_table()
DENSE_CAPACITIES = tuple(sorted(DENSE_TILE))
DENSE_THREADS = 256
# dense_cost's weights, in units of one product into a 4-word (6-limb)
# register: a product's register word, a decoded operand element, an output
# word summed at one level of the K split's tree, a level's barrier, a chunk
# of K (its two barriers). Fitted to the kernel's device times over every
# layout at the main path's shapes on an H100 (dense_times --sweep).
_WORD, _DECODE, _TREE_WORD, _LEVEL, _CHUNK = 0.25, 5.7, 0.8125, 1.4, 13.2
# C entry point and ctypes argument types of each kernel library, by source
# stem (csrc/<stem>.cu).
_ENTRIES = {
    "fdp_gemm": ("fdp_gemm_launch",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                 + [ctypes.c_int] * 14 + [ctypes.c_void_p]),
    "fdp_gemm_looped": ("fdp_gemm_looped_launch",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
                        + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "fdp_ragged_gemm": ("fdp_ragged_gemm_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 14
                        + [ctypes.c_void_p]),
    "fdp_ragged_dw": ("fdp_ragged_dw_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 14
                      + [ctypes.c_void_p]),
}
# The launch counters are read-modify-written from the caller's thread and,
# for a backward, from autograd's device thread.
_COUNT_LOCK = threading.Lock()

_libs = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the FDP kernels are built from "
                           f"{_CSRC} with the CUDA toolkit")
    return found


def build() -> dict:
    """Compile every ``csrc/*.cu`` into its own shared library, one ``nvcc``
    per source, all started together, and return ``{stem: path}``. The
    libraries are tagged with a hash of every file in ``csrc/`` (the shared
    header included) and the flags, so a changed source or header rebuilds
    and an unchanged one is reused."""
    files = sorted(p for p in _CSRC.iterdir() if p.is_file())
    digest = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
    for path in files:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    tag = digest.hexdigest()[:12]
    outs = {p.stem: _BUILD_DIR / f"lib{p.stem}-{tag}.so"
            for p in files if p.suffix == ".cu"}
    todo = [stem for stem, out in outs.items() if not out.exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in todo:
        tmp = outs[stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp)
    errors = []
    for stem, (proc, tmp) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {stem}.cu ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, outs[stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load() -> dict:
    """Build (if needed) and load the kernel libraries: ``{stem: CDLL}``."""
    global _libs
    if _libs is None:
        libs = {}
        for stem, path in build().items():
            lib = ctypes.CDLL(str(path))
            name, argtypes = _ENTRIES[stem]
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            libs[stem] = lib
        _libs = libs
    return _libs


def int32_ops(a_elems: int, b_elems: int, products: int, rne: bool = False) -> int:
    """int32 operations the FDP GEMM function needs, for its bound: one
    decode (8) per distinct operand element (``a_elems + b_elems``; a weight
    broadcast over the batch counts once), and per product the 64-bit
    significand product and its grid alignment (8), the four signed 16-bit
    pieces (8) and their adds into the four limbs they reach (4); RNE adds
    the guard/sticky/lsb test (12). Counted from the algorithm, not from
    compiled instructions; the kernels spend more (see the module note).
    For the sorted-segment function the counts are those of its data: the
    elements of the rows that fall in a group, the weights of the non-empty
    groups, and one product per (row in a group, d, f)."""
    return 8 * (a_elems + b_elems) + products * (20 + (12 if rne else 0))


def _carriers(fmt, *tensors: torch.Tensor) -> list:
    """The operands as the kernels read them: f32 for float formats (read as
    f32, as the reference decodes them), int32 bit patterns for posits."""
    core_fdp.check_format(fmt)
    if isinstance(fmt, PositFormat):
        if any(t.dtype != torch.int32 for t in tensors):
            raise TypeError(f"{fmt.name} takes int32 bit patterns, got "
                            f"{[t.dtype for t in tensors]}")
        return list(tensors)
    return [t.to(torch.float32) for t in tensors]


def _numerics_args(spec: AccumulatorSpec, fmt) -> tuple:
    """The (spec, format) arguments of both C entry points."""
    L = spec.num_limbs
    if L > MAX_LIMBS:
        raise ValueError(f"{spec.describe()} needs {L} limbs; the kernels are "
                         f"built for at most {MAX_LIMBS}")
    posit = isinstance(fmt, PositFormat)
    return (spec.lsb, spec.width, L, int(spec.round_mode == "rne"),
            int(spec.overflow_mode == "saturate"), int(posit),
            fmt.nbits if posit else 32, fmt.es if posit else 0)


def _count(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel. A launch made while the
    current stream is being captured into a CUDA graph runs nothing then: it
    counts in ``wrapper.captured``, and ``wrapper.launches`` counts only the
    launches that ran. A graph's replays go through no wrapper."""
    capturing = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            wrapper.captured += 1
        else:
            wrapper.launches += 1


def _check_device(*tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the FDP kernels run on CPU or CUDA tensors, not {dev}")
    return dev.type


@dataclasses.dataclass(frozen=True)
class DenseLaunch:
    """One launch of the dense kernel: register capacity ``lc`` (limbs), the
    thread layout (``tx`` columns x ``ty`` rows x ``ks`` K slices = 256
    threads, each thread owning ``tm`` x ``tn`` outputs) and ``bks``, the k
    each slice takes from a chunk of ``bk = ks * bks``."""

    lc: int
    tm: int
    tn: int
    tx: int
    ty: int
    ks: int
    bks: int

    @property
    def words(self) -> int:
        """32-bit words of the register: LC/2 + 1 hold any L <= LC limbs."""
        return self.lc // 2 + 1

    @property
    def tile(self) -> tuple:
        """The block's (BM, BN, BK)."""
        return self.ty * self.tm, self.tx * self.tn, self.ks * self.bks

    def grid(self, batch: int, rows: int, cols: int) -> tuple:
        bm, bn, _ = self.tile
        return -(-cols // bn), -(-rows // bm), batch


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(x, 1))))


def dense_layouts(num_limbs: int, rows: int, cols: int, depth: int):
    """Every launch of the dense kernel worth weighing for a (rows, depth) @
    (depth, cols) call at ``num_limbs`` limbs: the smallest capacity that
    holds them; a thread tile of its TM rows, or TM/2 or TM/4; 256 threads
    as tx columns x ty (at most 8) rows x ks K slices, powers of two; bks k
    a slice a chunk (1 to 32). A block tile no larger than the call's rows,
    columns and depth rounded up to powers of two, save one thread's columns
    and one k a slice; decoded tiles within DENSE_SMEM_LIMIT."""
    if not 1 <= num_limbs <= MAX_LIMBS:
        raise ValueError(f"{num_limbs} limbs: the dense kernel holds 1..{MAX_LIMBS}")
    lc = next(c for c in DENSE_CAPACITIES if c >= num_limbs)
    tm_max, tn = DENSE_TILE[lc]
    rows2, cols2, depth2 = _pow2_at_least(rows), _pow2_at_least(cols), _pow2_at_least(depth)
    for tm in sorted({tm_max, max(1, tm_max // 2), max(1, tm_max // 4)}, reverse=True):
        for ty in (1, 2, 4, 8):
            if ty * tm > rows2:
                continue
            for tx in (1 << i for i in range(9)):
                if tx * ty > DENSE_THREADS or tx * tn > max(tn, cols2):
                    continue
                ks = DENSE_THREADS // (tx * ty)
                for bks in (32, 16, 8, 4, 2, 1):
                    if (bks > 1 and ks * bks > depth2) \
                            or (ty * tm + tx * tn) * ks * bks * 8 > DENSE_SMEM_LIMIT:
                        continue
                    yield DenseLaunch(lc, tm, tn, tx, ty, ks, bks)


def dense_cost(lay: DenseLaunch, batch: int, rows: int, cols: int, depth: int,
               sms: int) -> float:
    """The time ``lay`` takes, in units of one product into a 4-word
    register: the waves of blocks the card runs (DENSE_RESIDENT blocks on
    each of ``sms`` multiprocessors at once) times a thread's work, its
    products (their words), its share of decoding the tiles, its K split's
    summing tree and its chunks. A model, fitted to device times; the
    launcher only compares it across layouts."""
    bm, bn, bk = lay.tile
    blocks = batch * -(-rows // bm) * -(-cols // bn)
    waves = -(-blocks // (sms * DENSE_RESIDENT[lay.lc]))
    chunks = -(-depth // bk)
    levels = math.log2(lay.ks)
    outputs = lay.tm * lay.tn
    work = (_WORD * lay.words * chunks * lay.bks * outputs
            + _DECODE * chunks * (bm + bn) * bk / DENSE_THREADS
            + _TREE_WORD * lay.words * levels * outputs + _LEVEL * levels + _CHUNK * chunks)
    return waves * work


def dense_candidates(num_limbs: int, batch: int, rows: int, cols: int, depth: int,
                     sms: int, top: int) -> list:
    """The ``top`` layouts of ``dense_layouts`` for a (batch, rows, depth) @
    (batch, depth, cols) call in ``dense_launch``'s order: least
    ``dense_cost`` first; on a tie, more rows a thread, then the smaller K
    split, then the deeper chunk. The first is ``dense_launch``'s pick. The
    autotuner times these (``core.dispatch._measure_plan``)."""
    return heapq.nsmallest(
        top, dense_layouts(num_limbs, rows, cols, depth),
        key=lambda lay: (dense_cost(lay, batch, rows, cols, depth, sms), -lay.tm,
                         lay.ks, -lay.bks))


@functools.lru_cache(maxsize=4096)
def dense_launch(num_limbs: int, batch: int, rows: int, cols: int, depth: int,
                 sms: int) -> DenseLaunch:
    """The dense kernel's launch for a (batch, rows, depth) @ (batch, depth,
    cols) call at ``num_limbs`` limbs on a card of ``sms`` multiprocessors:
    of ``dense_layouts``, the one of least ``dense_cost`` (the first of
    ``dense_candidates``). A plan with a measured launch overrides it
    (``dense_plan``)."""
    return dense_candidates(num_limbs, batch, rows, cols, depth, sms, 1)[0]


@functools.lru_cache(maxsize=4096)
def _layout_set(num_limbs: int, rows2: int, cols2: int, depth2: int) -> frozenset:
    # dense_layouts reads rows, cols and depth only through their powers of two
    return frozenset(dense_layouts(num_limbs, rows2, cols2, depth2))


def check_launch(lay: DenseLaunch, num_limbs: int, rows: int, cols: int,
                 depth: int) -> DenseLaunch:
    """``lay`` if it is one of ``dense_layouts`` for the call, else
    ValueError: a launch that the layouts of this call do not hold is
    refused, never replaced."""
    if lay not in _layout_set(num_limbs, _pow2_at_least(rows), _pow2_at_least(cols),
                              _pow2_at_least(depth)):
        raise ValueError(f"{lay} is not a layout of the dense kernel for a "
                         f"({rows}, {depth}) @ ({depth}, {cols}) call at {num_limbs} limbs")
    return lay


@functools.lru_cache(maxsize=4096)
def ragged_launch(num_limbs: int, T: int, E: int, d: int, f: int, sms: int) -> DenseLaunch:
    """The sorted-segment kernel's launch for ``x (T, d)`` against ``w (E,
    d, f)`` at ``num_limbs`` limbs on a card of ``sms`` multiprocessors:
    ``dense_launch`` for E groups (the batch) of ceil(T / E) rows, the rows
    a group holds on average. The group sizes stay on the device (reading
    them would wait for the router), so the shapes are all it knows."""
    return dense_launch(num_limbs, max(E, 1), max(1, -(-T // max(E, 1))), f, d, sms)


def ragged_dw_launch(num_limbs: int, T: int, E: int, d: int, f: int, sms: int) -> DenseLaunch:
    """The weight-gradient kernel's launch for ``x (T, d)`` and ``g (T, f)``
    in E groups at ``num_limbs`` limbs on a card of ``sms`` multiprocessors:
    ``dense_launch`` for E products (the batch) of d rows and f columns,
    ceil(T / E) deep (the rows a group holds on average). As for
    ``ragged_launch``, the group sizes stay on the device, so the shapes are
    all it knows. Its grid is ``grid(E, d, f)``: (column tiles, row tiles,
    groups)."""
    return dense_launch(num_limbs, max(E, 1), d, f, max(1, -(-T // max(E, 1))), sms)


def ragged_grid(lay: DenseLaunch, T: int, E: int, f: int) -> tuple:
    """The sorted-segment kernel's grid: (row tiles, column tiles). The E
    groups and the rows past their total are E + 1 segments of T rows, each
    tiled by BM rows on its own, so they need at most ceil(T / BM) + E row
    tiles."""
    bm, bn, _ = lay.tile
    return -(-T // bm) + E, -(-f // bn)


def fold_broadcast(a: torch.Tensor, b: torch.Tensor):
    """``(a', b')`` = a view of ``a`` as ``(1, B*M, K)`` and ``b[:1]`` when the
    weight ``b`` is broadcast over the batch (batch stride 0) and ``a``'s
    batch and rows merge into one dimension without a copy; else None. The
    folded call computes the same outputs, viewed back as (B, M, N), and
    reads the weight once."""
    if a.shape[0] < 2 or b.stride(0) != 0:
        return None
    try:
        folded = a.view(1, a.shape[0] * a.shape[1], a.shape[2])
    except RuntimeError:                          # the strides do not merge
        return None
    return folded, b[:1]


_GRID_YZ = 65535            # a grid's limit on its y and z axes


def launch_operands(a: torch.Tensor, b: torch.Tensor, num_limbs: int, sms: int) -> tuple:
    """``(a', b')``, the operands as the dense kernel launches them: folded
    (``fold_broadcast``) where the call folds and the folded rows fit the
    grid's 65535 row tiles under ``dense_launch``'s layout for them; else as
    given. Their shapes are the launch a plan is resolved for
    (``kernels.ops``), whatever launch the plan then names."""
    folded = fold_broadcast(a, b)
    if folded is not None:
        fa, fb = folded
        lay = dense_launch(num_limbs, 1, fa.shape[1], fb.shape[2], fa.shape[2], sms)
        if lay.grid(1, fa.shape[1], fb.shape[2])[1] <= _GRID_YZ:
            return fa, fb
    return a, b


def dense_plan(a: torch.Tensor, b: torch.Tensor, num_limbs: int, sms: int,
               launch: DenseLaunch | None = None) -> tuple:
    """``(a', b', launch)``: the operands as the dense kernel takes them
    (``launch_operands``) and the launch, ``dense_launch``'s or the given
    one, which must be one of the call's ``dense_layouts``. B and the row
    tiles must fit the grid, or ValueError."""
    a, b = launch_operands(a, b, num_limbs, sms)
    Bn, M, K = a.shape
    N = b.shape[2]
    lay = (dense_launch(num_limbs, Bn, M, N, K, sms) if launch is None
           else check_launch(launch, num_limbs, M, N, K))
    if lay.grid(Bn, M, N)[1] > _GRID_YZ or Bn > _GRID_YZ:
        raise ValueError(f"batch {Bn} or rows {M} exceed the kernel grid ({_GRID_YZ} "
                         f"tiles of {lay.tile[0]} rows, {_GRID_YZ} batch elements)")
    return a, b, lay


# The multiprocessors of the H100 SXM that dense_cost was fitted on: the
# layouts of a call on CPU tensors, which run the plain version, are weighed
# for it, so that a plan key names the same launch shape on either device.
PLAIN_SMS = 132


def device_sms(device: torch.device) -> int:
    """The multiprocessors a call's layouts are weighed for: the card's for
    a CUDA tensor, ``PLAIN_SMS`` for a CPU tensor."""
    if device.type != "cuda":
        return PLAIN_SMS
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fdp_gemm_plain(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
                   fmt) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``core.fdp.fdp_gemm`` per batch
    element, (B,M,K) @ (B,K,N) -> (B,M,N) f32."""
    out = [core_fdp.fdp_gemm(x, y, spec, fmt) for x, y in zip(a, b)]
    if not out:
        return torch.zeros((0, a.shape[1], b.shape[2]), dtype=torch.float32,
                           device=a.device)
    return torch.stack(out)


def fdp_gemm(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
             fmt, launch: DenseLaunch | None = None) -> torch.Tensor:
    """(B,M,K) @ (B,K,N) -> (B,M,N) f32 through the exact FDP datapath.

    ``a`` and ``b`` may have any strides, 0 included (a broadcast weight
    needs no copy, and is folded into the rows so that the kernel reads it
    once: ``dense_plan``). Float formats take float tensors (read as
    f32, as the reference decodes them); posit formats take int32 bit
    patterns. CPU tensors run ``fdp_gemm_plain``; CUDA tensors launch the
    kernel (counted in ``fdp_gemm.launches``) with ``launch``, or without
    one ``dense_launch``'s layout for the card's multiprocessor count. A
    ``launch`` that is not one of the call's ``dense_layouts`` raises
    ValueError, on CPU tensors too. Every layout gives the same bits."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"fdp_gemm expects (B,M,K) @ (B,K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    on = _check_device(a, b)
    a, b = _carriers(fmt, a, b)
    if on == "cpu":
        if launch is not None:
            dense_plan(a, b, spec.num_limbs, PLAIN_SMS, launch)
        return fdp_gemm_plain(a, b, spec=spec, fmt=fmt)
    numerics = _numerics_args(spec, fmt)
    shape = (a.shape[0], a.shape[1], b.shape[2])
    a, b, lay = dense_plan(a, b, spec.num_limbs, device_sms(a.device), launch)
    Bn, M, K = a.shape
    N = b.shape[2]
    out = torch.empty((Bn, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out.view(shape)
    lib = load()["fdp_gemm"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.fdp_gemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), Bn, M, N, K,
            *a.stride(), *b.stride(), *numerics, lay.lc, lay.tm, lay.tx, lay.ty,
            lay.ks, lay.bks, stream)
    if err != 0:
        raise RuntimeError(f"fdp_gemm kernel launch failed: cudaError {err}")
    _count(fdp_gemm)
    return out.view(shape)


fdp_gemm.launches = 0
fdp_gemm.captured = 0


def fdp_gemm_looped(a: torch.Tensor, b: torch.Tensor, plan, *, spec: AccumulatorSpec,
                    fmt) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) f32 through the exact FDP datapath in the
    seed's order. ``plan`` is a fitted ``GemmPlan``: a CUDA block covers its
    ``bm x bn`` output tile and carries normalize every ``bk`` products
    (``bk <= SAFE_CHUNK``, as ``GemmPlan.fit`` guarantees). ``a`` and ``b``
    may have any strides. CPU tensors run the plain version (the same
    function as ``fdp_gemm_plain``); CUDA tensors launch the kernel (counted
    in ``fdp_gemm_looped.launches``)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fdp_gemm_looped expects (M,K) @ (K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if not 1 <= plan.bk <= SAFE_CHUNK or plan.bm < 1 or plan.bn < 1:
        raise ValueError(f"plan {plan.tile} is not fitted: 1 <= bk <= SAFE_CHUNK "
                         f"({SAFE_CHUNK}) and positive bm, bn are required")
    on = _check_device(a, b)
    a, b = _carriers(fmt, a, b)
    if on == "cpu":
        return core_fdp.fdp_gemm(a, b, spec, fmt)
    numerics = _numerics_args(spec, fmt)
    M, K = a.shape
    N = b.shape[1]
    if -(-M // plan.bm) > 65535:
        raise ValueError(f"{M} rows exceed the kernel grid (65535 tiles of {plan.bm})")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = load()["fdp_gemm_looped"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.fdp_gemm_looped_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, plan.bm, plan.bn,
            plan.bk, *a.stride(), *b.stride(), *numerics, stream)
    if err != 0:
        raise RuntimeError(f"fdp_gemm_looped kernel launch failed: cudaError {err}")
    _count(fdp_gemm_looped)
    return out


fdp_gemm_looped.launches = 0
fdp_gemm_looped.captured = 0


def fdp_ragged_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                          group_sizes: torch.Tensor, *, spec: AccumulatorSpec,
                          fmt) -> torch.Tensor:
    """The sorted-segment kernel's plain PyTorch version:
    ``core.fdp.fdp_ragged_gemm`` (one ``fdp_gemm`` per group on its rows,
    zeros past the total)."""
    return core_fdp.fdp_ragged_gemm(x, w, group_sizes, spec, fmt)


def fdp_ragged_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                    spec: AccumulatorSpec, fmt) -> torch.Tensor:
    """Sorted-segment grouped GEMM: ``x (T, d)`` rows sorted by group, ``w
    (E, d, f)``, ``group_sizes (E,)`` non-negative rows per group -> ``(T,
    f)`` f32; row t against ``w[group(t)]`` through the exact FDP datapath,
    rows past ``sum(group_sizes)`` 0.0.

    ``x`` and ``w`` may have any strides. On CUDA tensors the kernel reads
    ``group_sizes`` on the device (the host never waits for it), with
    ``ragged_launch``'s layout for the card's multiprocessor count, and the
    launch is counted in ``fdp_ragged_gemm.launches``; CPU tensors run
    ``fdp_ragged_gemm_plain``."""
    if x.ndim != 2 or w.ndim != 3 or x.shape[1] != w.shape[1] \
            or tuple(group_sizes.shape) != (w.shape[0],):
        raise ValueError(f"fdp_ragged_gemm expects x (T,d), w (E,d,f), group_sizes "
                         f"(E,), got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    if group_sizes.dtype.is_floating_point or group_sizes.dtype.is_complex:
        raise TypeError(f"group_sizes must be integers, not {group_sizes.dtype}")
    on = _check_device(x, w, group_sizes)
    x, w = _carriers(fmt, x, w)
    if on == "cpu":
        return fdp_ragged_gemm_plain(x, w, group_sizes, spec=spec, fmt=fmt)
    numerics = _numerics_args(spec, fmt)
    T, d = x.shape
    E, _, f = w.shape
    out = torch.empty((T, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    lay = ragged_launch(spec.num_limbs, T, E, d, f, _sm_count(index))
    rows, cols = ragged_grid(lay, T, E, f)
    if cols > _GRID_YZ or rows > 2 ** 31 - 1:
        raise ValueError(f"{T} rows or {f} columns exceed the kernel grid (2^31 - 1 row "
                         f"tiles of {lay.tile[0]}, {_GRID_YZ} column tiles of "
                         f"{lay.tile[1]})")
    gs = group_sizes.to(torch.int32).contiguous()
    lib = load()["fdp_ragged_gemm"]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fdp_ragged_gemm_launch(
            x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(), T, E, d, f,
            *x.stride(), *w.stride(), *numerics, lay.lc, lay.tm, lay.tx, lay.ty, lay.ks,
            lay.bks, stream)
    if err != 0:
        raise RuntimeError(f"fdp_ragged_gemm kernel launch failed: cudaError {err}")
    _count(fdp_ragged_gemm)
    return out


fdp_ragged_gemm.launches = 0
fdp_ragged_gemm.captured = 0


def fdp_ragged_dw_plain(x: torch.Tensor, g: torch.Tensor, group_sizes: torch.Tensor,
                        *, spec: AccumulatorSpec, fmt) -> torch.Tensor:
    """The sorted-segment weight-gradient kernel's plain PyTorch version:
    ``core.fdp.fdp_ragged_dw`` (one ``fdp_gemm`` per group on its rows,
    exact zeros for a zero-size group)."""
    return core_fdp.fdp_ragged_dw(x, g, group_sizes, spec, fmt)


def fdp_ragged_dw(x: torch.Tensor, g: torch.Tensor, group_sizes: torch.Tensor, *,
                  spec: AccumulatorSpec, fmt) -> torch.Tensor:
    """Sorted-segment grouped weight gradient: ``x (T, d)`` and ``g (T, f)``
    rows sorted by group, ``group_sizes (E,)`` non-negative rows per group ->
    ``dW (E, d, f)`` f32 with ``dW[e] = x[rows of e]ᵀ @ g[rows of e]`` through
    the exact FDP datapath. A zero-size group gets exact zeros; rows past
    ``sum(group_sizes)`` add nothing.

    ``x`` and ``g`` may have any strides. On CUDA tensors the kernel reads
    ``group_sizes`` on the device (the host never waits for it), with
    ``ragged_dw_launch``'s layout for the card's multiprocessor count: a
    block computes one tile of one group's ``dW[e]``, its k stopping at the
    group's last row. The launch is counted in ``fdp_ragged_dw.launches``;
    CPU tensors run ``fdp_ragged_dw_plain``."""
    if x.ndim != 2 or g.ndim != 2 or x.shape[0] != g.shape[0] \
            or group_sizes.ndim != 1:
        raise ValueError(f"fdp_ragged_dw expects x (T,d), g (T,f), group_sizes (E,), "
                         f"got {tuple(x.shape)}, {tuple(g.shape)}, "
                         f"{tuple(group_sizes.shape)}")
    if group_sizes.dtype.is_floating_point or group_sizes.dtype.is_complex:
        raise TypeError(f"group_sizes must be integers, not {group_sizes.dtype}")
    on = _check_device(x, g, group_sizes)
    x, g = _carriers(fmt, x, g)
    if on == "cpu":
        return fdp_ragged_dw_plain(x, g, group_sizes, spec=spec, fmt=fmt)
    numerics = _numerics_args(spec, fmt)
    T, d = x.shape
    f = g.shape[1]
    E = group_sizes.shape[0]
    if E * d * f == 0:
        return torch.empty((E, d, f), dtype=torch.float32, device=x.device)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    lay = ragged_dw_launch(spec.num_limbs, T, E, d, f, _sm_count(index))
    _, rows, _ = lay.grid(E, d, f)
    if rows > _GRID_YZ or E > _GRID_YZ:
        raise ValueError(f"{d} rows or {E} groups exceed the kernel grid ({_GRID_YZ} row "
                         f"tiles of {lay.tile[0]}, {_GRID_YZ} groups)")
    out = torch.empty((E, d, f), dtype=torch.float32, device=x.device)
    gs = group_sizes.to(torch.int32).contiguous()
    lib = load()["fdp_ragged_dw"]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fdp_ragged_dw_launch(
            x.data_ptr(), g.data_ptr(), gs.data_ptr(), out.data_ptr(), T, E, d, f,
            *x.stride(), *g.stride(), *numerics, lay.lc, lay.tm, lay.tx, lay.ty, lay.ks,
            lay.bks, stream)
    if err != 0:
        raise RuntimeError(f"fdp_ragged_dw kernel launch failed: cudaError {err}")
    _count(fdp_ragged_dw)
    return out


fdp_ragged_dw.launches = 0
fdp_ragged_dw.captured = 0


# every kernel wrapper by name, each counting its launches in ``.launches``
# and the launches captured into a CUDA graph in ``.captured``
KERNELS = {"fdp_gemm": fdp_gemm, "fdp_gemm_looped": fdp_gemm_looped,
           "fdp_ragged_gemm": fdp_ragged_gemm, "fdp_ragged_dw": fdp_ragged_dw}
