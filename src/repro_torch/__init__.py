"""PyTorch/CUDA port of the numerically-tailored FDP GEMM system.

Counterpart of the JAX package ``repro`` (the reference it is held against),
for one NVIDIA Hopper GPU: the exact <ovf,msb,lsb> FDP GEMM as hand-written
``sm_90a`` CUDA kernels (``kernels``: dense and sorted-segment), their plain
PyTorch versions and per-site dispatch (``core``), the dense and MoE models
(``models``, ``configs``) and serving (``launch.serve``). It imports neither JAX nor the
JAX package.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
