"""The exact <ovf,msb,lsb> FDP GEMM as a hand-written Hopper kernel.

``fdp_gemm(a, b, spec=..., fmt=...)`` computes ``(B, M, K) @ (B, K, N) ->
(B, M, N)`` f32 with every product entered exactly into an int32-limb
register and one rounding per output. It replaces the Pallas body
``repro/kernels/fdp_gemm.py:fdp_gemm_kernel``, reached there through
``fdp_gemm_pallas_batched`` (every N-D call) and ``fdp_gemm_pallas`` (2-D
calls, which here are the batched call with B = 1).

What bounds it on the card: int32 CUDA-core operations per exact product
(form the 48-bit significand product, align it to the grid, add four
16-bit pieces into the limbs), not bytes and not the tensor cores, which
have no exact wide-integer accumulate. The simple design
(``csrc/fdp_gemm.cu``) keeps each output's limbs in registers, so the
placement is compare-and-select over a compile-time number of limbs with no
local-memory traffic, and splits K over eight threads per output, whose
registers are summed exactly in shared memory, so that decode shapes
(M = 1) still fill the card. It spends more operations than the function
needs: both operands are decoded per product and every limb is selected
per product. ``int32_ops`` counts what the function needs, whatever the
design; ``chip_smoke.py`` turns that count into the bound it reports.

On a CPU tensor the wrapper runs the plain PyTorch version
(``fdp_gemm_plain``, the port's ``simulate`` mode per batch element); on a
CUDA tensor it launches the kernel or raises. The kernel is compiled with
``nvcc`` for ``sm_90a`` at first use, from the source in ``csrc/``, into
``_build/`` beside this file (git ignores it), and bound through ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core import fdp as core_fdp
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.formats import PositFormat

_SRC = Path(__file__).resolve().parent / "csrc" / "fdp_gemm.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")
MAX_LIMBS = 40          # the widest instantiation in csrc/fdp_gemm.cu

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the FDP GEMM kernel is built from "
                           f"{_SRC} with the CUDA toolkit")
    return found


def build() -> Path:
    """Compile ``csrc/fdp_gemm.cu`` into a shared library (once per source
    version) and return its path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libfdp_gemm-{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fdp_gemm_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.fdp_gemm_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def int32_ops(a_elems: int, b_elems: int, products: int, rne: bool = False) -> int:
    """int32 operations the FDP GEMM function needs, for its bound: one
    decode (8) per distinct operand element (``a_elems + b_elems``; a weight
    broadcast over the batch counts once), and per product the 64-bit
    significand product and its grid alignment (8), the four signed 16-bit
    pieces (8) and their adds into the four limbs they reach (4); RNE adds
    the guard/sticky/lsb test (12). Counted from the algorithm, not from
    compiled instructions; the kernel spends more (see the module note)."""
    return 8 * (a_elems + b_elems) + products * (20 + (12 if rne else 0))


def _carrier_dtype(fmt) -> torch.dtype:
    return torch.int32 if isinstance(fmt, PositFormat) else torch.float32


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
    tensors run ``fdp_gemm_plain``; CUDA tensors launch the kernel (counted in ``fdp_gemm.launches``)."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"fdp_gemm expects (B,M,K) @ (B,K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    core_fdp.check_format(fmt)
    dt = _carrier_dtype(fmt)
    if a.dtype != dt or b.dtype != dt:
        if dt == torch.int32:
            raise TypeError(f"{fmt.name} takes int32 bit patterns, got "
                            f"{a.dtype} and {b.dtype}")
        a, b = a.to(dt), b.to(dt)
    if a.device.type == "cpu":
        return fdp_gemm_plain(a, b, spec=spec, fmt=fmt)
    if a.device.type != "cuda":
        raise ValueError(f"fdp_gemm runs on CPU or CUDA tensors, not {a.device}")
    L = spec.num_limbs
    if L > MAX_LIMBS:
        raise ValueError(f"{spec.describe()} needs {L} limbs; the kernel is "
                         f"built for at most {MAX_LIMBS}")
    Bn, M, K = a.shape
    N = b.shape[2]
    if M > 65535 or Bn > 65535:
        raise ValueError(f"batch {Bn} or rows {M} exceed the kernel grid (65535)")
    out = torch.empty((Bn, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    lib = load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    posit = isinstance(fmt, PositFormat)
    with torch.cuda.device(a.device):
        err = lib.fdp_gemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), Bn, M, N, K,
            *a.stride(), *b.stride(), spec.lsb, spec.width, L,
            int(spec.round_mode == "rne"), int(spec.overflow_mode == "saturate"),
            int(posit), fmt.nbits if posit else 32, fmt.es if posit else 0,
            stream)
    if err != 0:
        raise RuntimeError(f"fdp_gemm kernel launch failed: cudaError {err}")
    fdp_gemm.launches += 1
    return out


fdp_gemm.launches = 0
