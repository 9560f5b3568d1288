"""Plain oracle for the FDP GEMM kernel (counterpart of
``repro.kernels.ref``): ``core.fdp.fdp_gemm``, which is bit-equal to the JAX
reference; the CUDA kernel must agree with it bit for bit."""

from __future__ import annotations

import torch

from repro_torch.core import fdp
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.formats import FP32


def fdp_gemm_ref(a: torch.Tensor, b: torch.Tensor, *, spec: AccumulatorSpec,
                 fmt=FP32) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) f32 with exact <ovf,msb,lsb> accumulation."""
    return fdp.fdp_gemm(a, b, spec, fmt)
