"""Fused Dot Product (FDP), the paper's operator, in PyTorch.

``fdp_dot``/``fdp_gemm`` accumulate products in a <ovf,msb,lsb> fixed-point
register with NO intermediate rounding (one quantization at product entry,
one rounding at read-out). This is the port's ``simulate`` mode and the plain
version the CUDA kernel in ``repro_torch.kernels.fdp_gemm`` is held against;
it is bit-equal to ``repro.core.fdp``.
"""

from __future__ import annotations

import torch

from . import accumulator as acc
from .accumulator import SAFE_CHUNK, AccumulatorSpec
from .formats import FP32, FloatFormat, PositFormat

# Products per K chunk of ``fdp_gemm_limbs``: the chunk is min(K, 512) as in
# the reference, shrunk so that one chunk's (kc, M, N) temporaries stay near
# this many elements. The chunking only changes when carries normalize,
# which does not change the bits.
_CHUNK_PRODUCTS = 1 << 21
# Outputs per column block of ``fdp_gemm``: the (M, N, L) register of a
# wide output (a weight gradient of 6144 x 100352, or one expert's 6144 x
# 10752) is formed and read out a block of columns at a time, so its limbs
# and read-out temporaries stay near this many outputs. Each output column
# is independent, so the blocking does not change the bits.
_BLOCK_OUTPUTS = 1 << 22


def check_format(fmt) -> None:
    """Refuse formats whose significands exceed 24 bits (posit32_2 carries
    up to 28). The product entry keeps three 16-bit digits of the exact
    significand product, which holds 24x24 bits; the JAX reference silently
    overflows its int32 digits for wider inputs."""
    if fmt.precision > 24:
        raise ValueError(f"{fmt.name}: {fmt.precision}-bit significands exceed "
                         f"the 48-bit exact product of the FDP datapath")


def fdp_dot(a: torch.Tensor, b: torch.Tensor, spec: AccumulatorSpec,
            fmt: FloatFormat | PositFormat = FP32) -> torch.Tensor:
    """Exact-accumulation dot product of 1-D vectors -> f32 (RNE once)."""
    return acc.to_float(spec, fdp_dot_limbs(a, b, spec, fmt))


def fdp_dot_limbs(a: torch.Tensor, b: torch.Tensor, spec: AccumulatorSpec,
                  fmt: FloatFormat | PositFormat = FP32) -> torch.Tensor:
    """Accumulator register (carry-normalized limbs) of dot(a, b)."""
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"fdp_dot expects equal 1-D shapes, got {a.shape}, {b.shape}")
    check_format(fmt)
    da, db = fmt.decode(a), fmt.decode(b)
    state = torch.zeros(spec.num_limbs, dtype=torch.int32, device=a.device)
    for k0 in range(0, a.shape[0], SAFE_CHUNK):
        sl = slice(k0, k0 + SAFE_CHUNK)
        part = acc.product_limb_block_sum(
            spec, da.map(lambda x: x[sl]), db.map(lambda x: x[sl]))
        state = acc.carry_normalize(spec, state.to(torch.int64) + part)
    return state


def fdp_gemm_limbs(a: torch.Tensor, b: torch.Tensor, spec: AccumulatorSpec,
                   fmt: FloatFormat | PositFormat = FP32) -> torch.Tensor:
    """The accumulator register of a GEMM: (M,K) @ (K,N) -> (M,N,L) int32
    carry-normalized limbs, with no read-out rounding applied. Limb addition
    is exact, so the register of a full-K GEMM equals the carry-normalized
    limb-wise sum of the registers of any K-partition."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fdp_gemm expects (M,K) @ (K,N), got {a.shape}, {b.shape}")
    check_format(fmt)
    M, K = a.shape
    N = b.shape[1]
    da = fmt.decode(a).map(lambda x: x.T)                   # fields (K, M)
    db = fmt.decode(b)                                      # fields (K, N)
    kc = max(1, min(K, 512, _CHUNK_PRODUCTS // max(1, M * N)))
    state = torch.zeros((M, N, spec.num_limbs), dtype=torch.int32, device=a.device)
    for k0 in range(0, K, kc):
        sl = slice(k0, k0 + kc)
        part = acc.product_limb_block_sum(
            spec, da.map(lambda x: x[sl, :, None]), db.map(lambda x: x[sl, None, :]))
        state = acc.carry_normalize(spec, state.to(torch.int64) + part)
    return state


def fdp_gemm(a: torch.Tensor, b: torch.Tensor, spec: AccumulatorSpec,
             fmt: FloatFormat | PositFormat = FP32) -> torch.Tensor:
    """GEMM with FDP accumulation: (M,K) @ (K,N) -> (M,N) f32."""
    M, N = a.shape[0], b.shape[-1]
    nb = max(1, _BLOCK_OUTPUTS // max(1, M))
    if N <= nb:
        return acc.to_float(spec, fdp_gemm_limbs(a, b, spec, fmt))
    return torch.cat([acc.to_float(spec, fdp_gemm_limbs(a, b[:, n0:n0 + nb], spec, fmt))
                      for n0 in range(0, N, nb)], dim=1)


def fdp_ragged_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                    spec: AccumulatorSpec,
                    fmt: FloatFormat | PositFormat = FP32) -> torch.Tensor:
    """Grouped (expert) GEMM with FDP accumulation: ``x (T, d)`` rows sorted
    by group, ``w (E, d, f)``, ``group_sizes (E,)`` -> ``(T, f)`` f32. Row t
    contracts against its group's weights; rows past ``sum(group_sizes)``
    are 0.0. One ``fdp_gemm`` per non-empty group on its rows (T*d*f
    products; the reference's ``simulate`` mode runs every group over all T
    rows and selects, which gives the same bits because each output row
    depends only on its own row and weights). Reads the group sizes on the
    host."""
    T, f = x.shape[0], w.shape[2]
    out = torch.zeros((T, f), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        stop = min(T, start + n)
        if stop > start:
            out[start:stop] = fdp_gemm(x[start:stop], w[e], spec, fmt)
        start = stop
    return out


def fdp_ragged_dw(x: torch.Tensor, g: torch.Tensor, group_sizes: torch.Tensor,
                  spec: AccumulatorSpec,
                  fmt: FloatFormat | PositFormat = FP32) -> torch.Tensor:
    """Grouped weight gradient with FDP accumulation: ``x (T, d)`` and ``g
    (T, f)`` rows sorted by group, ``group_sizes (E,)`` -> ``dW (E, d, f)``
    f32, ``dW[e] = x[rows of e]ᵀ @ g[rows of e]``. One ``fdp_gemm`` per
    non-empty group on its rows; a zero-size group gets exact zeros and rows
    past ``sum(group_sizes)`` add nothing. The reference's ``simulate`` mode
    runs every group over all T rows with the other groups' rows zeroed;
    zero products add nothing to the limb register, so the bits are the
    same. Reads the group sizes on the host."""
    T, d, f = x.shape[0], x.shape[1], g.shape[1]
    out = torch.zeros((group_sizes.shape[0], d, f), dtype=torch.float32,
                      device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        stop = min(T, start + n)
        if stop > start:
            out[e] = fdp_gemm(x[start:stop].T, g[start:stop], spec, fmt)
        start = stop
    return out
