"""Public wrappers around the FDP kernels (counterpart of
``repro.kernels.ops``: 2-D, batched and sorted-segment entry points, the
last both forward and weight gradient).

Every entry point takes ``plan: GemmPlan | None`` as the reference's
GemmPlan-first API does, and a given plan is checked through
``resolve_plan``. The vector kernels' tile is fixed (``csrc/``), so no plan
changes their launch; the seed-order kernel of ``fdp_gemm(impl="loop")``
takes its block tile and carry cadence from the fitted plan. Every kernel
masks ragged edges itself, so no operand is padded.
"""

from __future__ import annotations

import torch

from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import GemmPlan
from repro_torch.core.formats import FP32

from . import fdp_gemm as _k

# Default tile when a caller passes no plan (the reference's default).
_DEFAULT_TILE = (32, 32, 128)


def resolve_plan(plan, M: int, N: int, K: int) -> GemmPlan:
    """Normalize the tiling argument of one kernel call into a fitted
    GemmPlan."""
    if plan is None:
        plan = GemmPlan(*_DEFAULT_TILE)
    if not isinstance(plan, GemmPlan):
        raise TypeError(f"plan must be a GemmPlan or None, got {plan!r}")
    return plan.fit(M, N, K)


def fdp_gemm(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
             fmt=FP32, plan: GemmPlan | None = None,
             impl: str = "vector") -> torch.Tensor:
    """GEMM with tailored FDP accumulation: (M,K)@(K,N) -> (M,N) f32.

    ``impl="vector"`` (the default) runs the batched kernel with B = 1;
    ``impl="loop"`` runs the seed-order kernel (``fdp_gemm_looped``), whose
    block covers the fitted plan's tile (``_DEFAULT_TILE`` without a plan)
    and whose carries normalize every ``bk`` products. Same bits either
    way."""
    if impl == "vector":
        if plan is not None:
            resolve_plan(plan, a.shape[0], b.shape[1], a.shape[1])
        return _k.fdp_gemm(a[None], b[None], spec=spec, fmt=fmt)[0]
    if impl == "loop":
        p = resolve_plan(plan, a.shape[0], b.shape[1], a.shape[1])
        return _k.fdp_gemm_looped(a, b, p, spec=spec, fmt=fmt)
    raise ValueError(f"unknown impl {impl!r}")


def fdp_gemm_batched(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
                     fmt=FP32, plan: GemmPlan | None = None) -> torch.Tensor:
    """Batched GEMM: (B,M,K)@(B,K,N) -> (B,M,N) f32 in one launch."""
    if plan is not None:
        resolve_plan(plan, a.shape[1], b.shape[2], a.shape[2])
    return _k.fdp_gemm(a, b, spec=spec, fmt=fmt)


def fdp_ragged_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
                    spec: AccumulatorSpec, fmt=FP32,
                    plan: GemmPlan | None = None) -> torch.Tensor:
    """Sorted-segment grouped GEMM: ``x (T, d)`` rows sorted by group, ``w
    (E, d, f)``, ``group_sizes (E,)`` -> ``(T, f)`` f32, rows past
    ``sum(group_sizes)`` zero, in one launch of the sorted-segment kernel."""
    if plan is not None:
        resolve_plan(plan, x.shape[0], w.shape[2], x.shape[1])
    return _k.fdp_ragged_gemm(x, w, group_sizes, spec=spec, fmt=fmt)


def fdp_ragged_dw(x: torch.Tensor, g: torch.Tensor, group_sizes: torch.Tensor, *,
                  num_groups: int, spec: AccumulatorSpec, fmt=FP32,
                  plan: GemmPlan | None = None) -> torch.Tensor:
    """Sorted-segment grouped weight gradient: ``dW[e] = X_eᵀ · G_e`` for ``x
    (T, d)`` / ``g (T, f)`` rows sorted by group -> ``(E, d, f)`` f32, in one
    launch of the weight-gradient kernel. Zero-size groups (leading,
    inner or trailing) get exact zeros. ``plan`` is checked against the
    (d, f, T) problem, as in the reference."""
    if tuple(group_sizes.shape) != (num_groups,):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != ({num_groups},)")
    if plan is not None:
        resolve_plan(plan, x.shape[1], g.shape[1], x.shape[0])
    return _k.fdp_ragged_dw(x, g, group_sizes, spec=spec, fmt=fmt)


def matmul_batching(f2d, f3d):
    """Wrap a 2-D kernel and a flat-batched 3-D kernel into one
    ``torch.matmul``-shaped callable: 1-D operands are promoted (and the
    result squeezed back), leading batch dims broadcast numpy-style and
    flatten into the 3-D kernel's batch axis.

    Broadcasting uses ``expand``, and the flattening ``reshape`` stays a
    view wherever the strides allow it, which they always do for an operand
    broadcast from 2-D: a weight reaches the kernel with batch stride 0
    instead of as B copies (the reference's ``broadcast_to`` materializes
    them; the bits are the same)."""
    def call(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        squeeze_a = a.ndim == 1
        squeeze_b = b.ndim == 1
        if squeeze_a:
            a = a[None, :]
        if squeeze_b:
            b = b[:, None]
        if a.ndim == 2 and b.ndim == 2:
            out = f2d(a, b)
        else:
            batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
            a = a.expand(batch + a.shape[-2:])
            b = b.expand(batch + b.shape[-2:])
            out = f3d(a.reshape((-1,) + a.shape[-2:]),
                      b.reshape((-1,) + b.shape[-2:]))
            out = out.reshape(batch + out.shape[-2:])
        if squeeze_a:
            out = out[..., 0, :]
        if squeeze_b:
            out = out[..., 0] if squeeze_a else out[..., :, 0]
        return out

    return call


def fdp_gemm_nd(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
                fmt=FP32, plan: GemmPlan | None = None) -> torch.Tensor:
    """``torch.matmul``-shaped entry point: 1-D promotion, numpy broadcasting
    of leading batch dims, then the 2-D call or one batched launch."""
    f2d = lambda x, y: fdp_gemm(x, y, spec=spec, fmt=fmt, plan=plan)
    f3d = lambda x, y: fdp_gemm_batched(x, y, spec=spec, fmt=fmt, plan=plan)
    return matmul_batching(f2d, f3d)(a, b)
