"""Public wrappers around the FDP kernels (counterpart of
``repro.kernels.ops``: 2-D, batched and sorted-segment entry points, the
last both forward and weight gradient).

Every entry point takes ``plan: GemmPlan | None`` as the reference's
GemmPlan-first API does. The dense entry points (``fdp_gemm``,
``fdp_gemm_batched``), called without a plan, resolve one through
``core.dispatch.plan_gemm`` for the launch the kernel makes: (B, M, N, K)
after a weight broadcast over the batch is folded into the rows
(``fdp_gemm.launch_operands``), on CPU tensors too. This is the
reference's ``_plan_for_operands``, one lookup per FDP dispatch; its keys
differ from the reference's only where a weight is folded ((B, S, d) @
(d, f) is keyed (1, B*S, f, d), where the reference keys batch B), so that
a stored launch is always a layout of the launch made. A plan that names a
launch (measured, or preloaded from the schedule zoo) runs the dense
kernel with it, and one that is not a layout of the call raises; a plan
without one leaves the layout to ``fdp_gemm.dense_launch``. Every layout
gives the same bits. The sorted-segment kernels take their layouts from
the shapes (``ragged_launch``, ``ragged_dw_launch``), and a plan given to
them is only checked; the seed-order kernel of ``fdp_gemm(impl="loop")``
takes its block tile and carry cadence from the fitted plan. Every kernel
masks ragged edges itself, so no operand is padded.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dispatch
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


def _dense(a: torch.Tensor, b: torch.Tensor, spec: AccumulatorSpec, fmt,
           plan: GemmPlan | None) -> torch.Tensor:
    """One dense-kernel call (B,M,K) @ (B,K,N) under ``plan``, or without
    one under the plan ``plan_gemm`` resolves for the launch made. The
    operands are cast to their carriers first: the fold reads the strides
    that the kernel gets."""
    a, b = _k._carriers(fmt, a, b)
    fa, fb = _k.launch_operands(a, b, spec.num_limbs, _k.device_sms(a.device))
    batch, M, K = fa.shape
    N = fb.shape[2]
    if plan is None:
        plan = dispatch.plan_gemm(M, N, K, fmt=fmt, spec=spec, batch=batch,
                                  backend=a.device.type)
    else:
        plan = resolve_plan(plan, M, N, K)
    launch = None if plan.launch is None else _k.DenseLaunch(*plan.launch)
    out = _k.fdp_gemm(fa, fb, spec=spec, fmt=fmt, launch=launch)
    return out.view(a.shape[0], a.shape[1], N)


def fdp_gemm(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
             fmt=FP32, plan: GemmPlan | None = None,
             impl: str = "vector") -> torch.Tensor:
    """GEMM with tailored FDP accumulation: (M,K)@(K,N) -> (M,N) f32.

    ``impl="vector"`` (the default) runs the batched kernel with B = 1;
    ``impl="loop"`` runs the seed-order kernel (``fdp_gemm_looped``), whose
    block covers the fitted plan's tile (``_DEFAULT_TILE`` without a plan;
    a plan's launch does not apply to it) and whose carries normalize every
    ``bk`` products. Same bits either way."""
    if impl == "vector":
        return _dense(a[None], b[None], spec, fmt, plan)[0]
    if impl == "loop":
        p = resolve_plan(plan, a.shape[0], b.shape[1], a.shape[1])
        if p.launch is not None:
            p = resolve_plan(dataclasses.replace(p, launch=None), a.shape[0], b.shape[1],
                             a.shape[1])
        return _k.fdp_gemm_looped(a, b, p, spec=spec, fmt=fmt)
    raise ValueError(f"unknown impl {impl!r}")


def fdp_gemm_batched(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
                     fmt=FP32, plan: GemmPlan | None = None) -> torch.Tensor:
    """Batched GEMM: (B,M,K)@(B,K,N) -> (B,M,N) f32 in one launch."""
    return _dense(a, b, spec, fmt, plan)


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
