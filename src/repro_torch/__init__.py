"""PyTorch/CUDA port of the numerically-tailored FDP GEMM system.

Counterpart of the JAX package ``repro`` (the reference it is held against),
for one NVIDIA Hopper GPU: the exact <ovf,msb,lsb> FDP GEMM as a
hand-written ``sm_90a`` CUDA kernel (``kernels``), its plain PyTorch version
and per-site dispatch (``core``), the dense model zoo (``models``,
``configs``) and serving (``launch.serve``). It imports neither JAX nor the
JAX package.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
