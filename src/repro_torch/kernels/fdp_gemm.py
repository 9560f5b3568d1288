"""The exact <ovf,msb,lsb> FDP GEMM kernels, hand-written for Hopper.

``fdp_gemm(a, b, spec=..., fmt=...)`` computes ``(B, M, K) @ (B, K, N) ->
(B, M, N)`` f32 with every product entered exactly into an int32-limb
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
of the kernel finds its row's group from the group sizes on the device, so
no tile table is built and the host never reads the sizes.

``fdp_ragged_dw(x, g, group_sizes, spec=..., fmt=...)`` is the
sorted-segment MoE weight gradient: ``x (T, d)``, ``g (T, f)`` rows sorted by
group -> ``dW (E, d, f)`` f32, ``dW[e] = x[rows of e]ᵀ @ g[rows of e]``, exact
zeros for a zero-size group. It replaces the Pallas body
``fdp_ragged_dw_kernel`` (through ``fdp_ragged_dw_pallas``); each thread
finds its group's row window from the group sizes on the device.

What bounds all four on the card: int32 CUDA-core operations per exact product
(form the 48-bit significand product, align it to the grid, add four
16-bit pieces into the limbs), not bytes and not the tensor cores, which
have no exact wide-integer accumulate. The simple design (``csrc/``; the
device math is ``csrc/fdp_common.cuh``, shared by all four kernels) keeps each
output's limbs in registers, so the placement is compare-and-select over a
compile-time number of limbs with no local-memory traffic. The two forward
kernels split K over eight threads per output, whose registers are summed
exactly in shared memory, so that decode shapes (M = 1, or 16 expert rows)
still fill the card; the weight-gradient kernel, whose K is a group's few
rows and whose outputs number E*d*f, and the seed-order kernel, whose
point is the per-k order, give each output one thread. They spend more
operations than the function needs: both operands are decoded per product
and every limb is selected per product. ``int32_ops``
counts what the function needs, whatever the design; ``chip_smoke.py``
turns that count into the bound it reports.

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
import hashlib
import os
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
MAX_LIMBS = 40          # the widest instantiation in csrc/fdp_common.cuh
# C entry point and ctypes argument types of each kernel library, by source
# stem (csrc/<stem>.cu).
_ENTRIES = {
    "fdp_gemm": ("fdp_gemm_launch",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "fdp_gemm_looped": ("fdp_gemm_looped_launch",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
                        + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "fdp_ragged_gemm": ("fdp_ragged_gemm_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p]),
    "fdp_ragged_dw": ("fdp_ragged_dw_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8
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
    with _COUNT_LOCK:
        wrapper.launches += 1


def _check_device(*tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the FDP kernels run on CPU or CUDA tensors, not {dev}")
    return dev.type


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
             fmt) -> torch.Tensor:
    """(B,M,K) @ (B,K,N) -> (B,M,N) f32 through the exact FDP datapath.

    ``a`` and ``b`` may have any strides, 0 included (a broadcast weight
    needs no copy). Float formats take float tensors (read as f32, as the
    reference decodes them); posit formats take int32 bit patterns. CPU
    tensors run ``fdp_gemm_plain``; CUDA tensors launch the kernel (counted
    in ``fdp_gemm.launches``)."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"fdp_gemm expects (B,M,K) @ (B,K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    on = _check_device(a, b)
    a, b = _carriers(fmt, a, b)
    if on == "cpu":
        return fdp_gemm_plain(a, b, spec=spec, fmt=fmt)
    numerics = _numerics_args(spec, fmt)
    Bn, M, K = a.shape
    N = b.shape[2]
    if M > 65535 or Bn > 65535:
        raise ValueError(f"batch {Bn} or rows {M} exceed the kernel grid (65535)")
    out = torch.empty((Bn, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = load()["fdp_gemm"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.fdp_gemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), Bn, M, N, K,
            *a.stride(), *b.stride(), *numerics, stream)
    if err != 0:
        raise RuntimeError(f"fdp_gemm kernel launch failed: cudaError {err}")
    _count(fdp_gemm)
    return out


fdp_gemm.launches = 0


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
    ``group_sizes`` on the device (the host never waits for it) and the
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
    if -(-f // 32) > 65535:
        raise ValueError(f"{f} columns exceed the kernel grid (65535 tiles of 32)")
    out = torch.empty((T, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    gs = group_sizes.to(torch.int32).contiguous()
    lib = load()["fdp_ragged_gemm"]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fdp_ragged_gemm_launch(
            x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(), T, E, d, f,
            *x.stride(), *w.stride(), *numerics, stream)
    if err != 0:
        raise RuntimeError(f"fdp_ragged_gemm kernel launch failed: cudaError {err}")
    _count(fdp_ragged_gemm)
    return out


fdp_ragged_gemm.launches = 0


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
    ``group_sizes`` on the device and the launch is counted in
    ``fdp_ragged_dw.launches``; CPU tensors run ``fdp_ragged_dw_plain``."""
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
    if -(-d // 8) > 65535 or E > 65535:
        raise ValueError(f"{d} rows or {E} groups exceed the kernel grid (65535)")
    out = torch.empty((E, d, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    gs = group_sizes.to(torch.int32).contiguous()
    lib = load()["fdp_ragged_dw"]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fdp_ragged_dw_launch(
            x.data_ptr(), g.data_ptr(), gs.data_ptr(), out.data_ptr(), T, E, d, f,
            *x.stride(), *g.stride(), *numerics, stream)
    if err != 0:
        raise RuntimeError(f"fdp_ragged_dw kernel launch failed: cudaError {err}")
    _count(fdp_ragged_dw)
    return out


fdp_ragged_dw.launches = 0
