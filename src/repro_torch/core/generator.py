"""The kernel *generator*, the flopoco analogue (counterpart of
``repro.core.generator``).

``generate_gemm(spec, fmt, target)`` returns a GEMM callable plus a
flopoco-style datapath report (resource estimate, power, tiling). Targets:

    * ``simulate`` - the bit-exact FDP in plain PyTorch (``core.fdp``)
    * ``pallas``   - the FDP GEMM kernel (``kernels.ops.fdp_gemm``): the
                     hand-written CUDA kernel on CUDA tensors, its plain
                     version on CPU tensors
    * ``native``   - a float matmul with fp32 accumulation (the
                     "conventional FPU" point in the design space)

The report's fields and values are the reference's, so reports compare
equal across the two packages: ``vmem_bytes_per_tile`` and
``pj_per_mac_tpu_model`` are outputs of the reference's resource and energy
models (``core.energy``) under their reference names, not measurements of
the card.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from . import energy
from .accumulator import AccumulatorSpec
from .formats import FP32, FloatFormat, PositFormat, get_format


@dataclasses.dataclass(frozen=True)
class DatapathReport:
    """What the generator 'synthesized' (flopoco report analogue)."""

    name: str
    fmt: str
    spec: AccumulatorSpec
    target: str
    num_limbs: int
    digit_mults_per_mac: int        # 12x12 partial products per MAC
    int_ops_per_mac: int
    vmem_bytes_per_tile: int
    tile: tuple
    watts_fpga_model: float         # VU3P-calibrated model
    pj_per_mac_tpu_model: float

    def describe(self) -> str:
        return (f"[generator] {self.name}: fmt={self.fmt} {self.spec.describe()} "
                f"target={self.target} tile={self.tile} "
                f"limbs={self.num_limbs} vmem/tile={self.vmem_bytes_per_tile}B "
                f"P_model={self.watts_fpga_model:.3f}W "
                f"E_tpu={self.pj_per_mac_tpu_model:.1f}pJ/MAC")


@dataclasses.dataclass(frozen=True)
class GeneratedGemm:
    fn: Callable                    # (a, b) -> f32 (M,N)
    report: DatapathReport


def generate_gemm(spec: AccumulatorSpec | None,
                  fmt: FloatFormat | PositFormat | str = FP32,
                  target: str = "simulate",
                  tile: tuple | None = None) -> GeneratedGemm:
    """Generate a GEMM kernel for a numerical spec (None = native fp32 acc).

    ``tile=None`` resolves block sizes through ``dispatch.plan_gemm`` per
    call shape (cached); an explicit (bm, bn, bk) becomes ``GemmPlan(*tile)``."""
    if isinstance(fmt, str):
        fmt = get_format(fmt)

    if target == "native" or spec is None:
        if isinstance(fmt, PositFormat):
            raise ValueError("posit inputs have no native MXU path")

        def native(a, b):
            # operands on the format's grid, products summed in f32 (the
            # reference's preferred_element_type=f32; TF32 is pinned off in
            # core.dispatch)
            return torch.matmul(fmt.quantize(a), fmt.quantize(b))

        rep = _native_report("native_mxu", fmt, spec, tile)
        return GeneratedGemm(native, rep)

    if target == "simulate":
        from . import fdp

        fn = partial(fdp.fdp_gemm, spec=spec, fmt=fmt)
        rep = _report("fdp_sim", fmt, spec, "simulate", tile)
        return GeneratedGemm(fn, rep)

    if target == "pallas":
        from repro_torch.kernels import ops as kops

        from . import dispatch

        if tile is None:

            def fn(a, b):
                p = dispatch.plan_gemm(a.shape[0], b.shape[1], a.shape[1],
                                       fmt=fmt, spec=spec)
                return kops.fdp_gemm(a, b, spec=spec, fmt=fmt, plan=p)
        else:
            fn = partial(kops.fdp_gemm, spec=spec, fmt=fmt,
                         plan=dispatch.GemmPlan(*tile))
        rep = _report("fdp_pallas", fmt, spec, "pallas", tile)
        return GeneratedGemm(fn, rep)

    raise ValueError(f"unknown target {target!r}")


def datapath_report(spec: AccumulatorSpec | None,
                    fmt: FloatFormat | PositFormat | str = FP32,
                    target: str = "simulate",
                    tile: tuple | None = None,
                    name: str | None = None) -> DatapathReport:
    """The generator's report alone, without building a kernel: what the
    tailoring search attaches to every candidate ⟨format, accumulator,
    backend⟩ point so its Pareto axes (modeled watts, pJ/MAC, VMEM) come from
    the same model as the generated datapaths.

    ``spec=None`` describes the conventional-FPU native path (fp32
    accumulate): FMA power model, MXU pJ/MAC, no limb machinery.
    """
    if isinstance(fmt, str):
        fmt = get_format(fmt)
    if spec is None or target == "native":
        return _native_report(name or "native_mxu", fmt, spec, tile)
    return _report(name or f"fdp_{target}", fmt, spec, target, tile)


def _native_report(name, fmt, spec, tile):
    """Report for the MXU/native fp32-accumulate path: the conventional-FMA
    point of the design space (no limbs, no int-op algebra)."""
    spec_eff = spec or AccumulatorSpec(ovf=8, msb=128, lsb=-126)  # ~fp32 acc
    bm, bn, bk = tile if tile is not None else (128, 128, 1024)
    vmem = (bm * bk + bk * bn) * 4 + bm * bn * 4
    return DatapathReport(
        name=name, fmt=fmt.name, spec=spec_eff, target="native",
        num_limbs=0, digit_mults_per_mac=0, int_ops_per_mac=0,
        vmem_bytes_per_tile=vmem,
        tile=tile if tile is not None else "auto",
        watts_fpga_model=energy.gemm_power(fmt, None).watts,
        pj_per_mac_tpu_model=energy.TPU_PJ_PER_MXU_MAC,
    )


def _report(name, fmt, spec, target, tile):
    digits = -(-fmt.precision // 12)
    L = spec.num_limbs
    int_ops = digits * digits + 2 * digits * L + L
    # tile=None (auto-plan): estimate VMEM with the planner's largest tile
    bm, bn, bk = tile if tile is not None else (128, 128, 1024)
    vmem = (bm * bk + bk * bn) * 4 + bm * bn * L * 4
    return DatapathReport(
        name=name, fmt=fmt.name, spec=spec, target=target,
        num_limbs=L, digit_mults_per_mac=digits * digits,
        int_ops_per_mac=int_ops, vmem_bytes_per_tile=vmem,
        tile=tile if tile is not None else "auto",
        watts_fpga_model=energy.spec_power(fmt, spec).watts,
        pj_per_mac_tpu_model=energy.tpu_fdp_pj_per_mac(fmt.precision, L),
    )
