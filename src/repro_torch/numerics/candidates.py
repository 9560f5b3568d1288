"""Per-site candidate enumeration (counterpart of
``repro.numerics.candidates``): the (format x AccumulatorSpec x backend)
grid, pruned by the exponent ranges observed in the calibration trace.

The msb is *derived* from the site's observed product bound plus K-term sum
growth (an accumulator that can wrap on calibration data is never a
candidate), and the lsb never extends below the point where the
accumulation is already bit-exact for the observed operand range. Each
candidate carries the generator's datapath report, so the Pareto axes
(modeled watts, pJ/MAC) come from the same model as the generated kernels.

Phase-qualified backward sites (``attn_qk@bwd.dA``) enumerate through the
same grid, pruned by their own recorded cotangent/operand ranges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import GemmConfig
from repro_torch.core.formats import BF16, FP32, PositFormat
from repro_torch.core.generator import DatapathReport, datapath_report
from repro_torch.core.qformat import FP32_STATE, QuantConfig, quant_bytes

from .trace import SiteProfile

# Default tailoring grid: accumulator widths swept per site (the paper's
# Fig. 3 x-axis, minus the points the trace prunes), and the input formats
# considered. Native (fp32-accumulate) candidates ride along per format.
DEFAULT_WIDTHS = (24, 40, 64)
DEFAULT_FORMATS = (BF16, FP32)

# Block-scaled grid for aux (state/collective) sites: payload bit widths and
# elements-per-exponent block. fp32 rides along as the identity reference.
QUANT_BITS = (4, 8, 16)
QUANT_BLOCKS = (32, 64)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the per-site tailoring space."""

    cfg: GemmConfig
    report: DatapathReport

    @property
    def tag(self) -> str:
        return self.cfg.tag()

    @property
    def watts(self) -> float:
        return self.report.watts_fpga_model

    def describe(self) -> str:
        return f"{self.tag} ({self.watts:.3f} W model)"


def _mk(cfg: GemmConfig) -> Candidate:
    return Candidate(cfg, datapath_report(cfg.acc, cfg.fmt, cfg.mode))


def enumerate_candidates(
        profile: SiteProfile, *,
        formats: Sequence = DEFAULT_FORMATS,
        widths: Sequence[int] = DEFAULT_WIDTHS,
        fdp_mode: str = "simulate",
        include_native: bool = True,
        include_paper91: bool = True,
        ovf: Optional[int] = None) -> list[Candidate]:
    """The pruned candidate grid for one traced site.

    * msb is pinned at ``profile.msb_required`` (no overflow on observed data),
    * each requested total width W places lsb at ``msb + ovf + 1 - W``,
      clamped at the site's bit-exact depth (``lsb_exact``): widths that
      would only add always-zero low bits collapse onto the exact point,
    * native (fp32-accumulate) candidates are included per FloatFormat,
    * the paper's uniform ⟨30,30,-30⟩ is kept as the reference point.
    """
    ovf = profile.sum_growth_bits + 1 if ovf is None else ovf
    msb = profile.msb_required
    out: list[Candidate] = []
    seen: set = set()

    def push(cfg: GemmConfig):
        key = (cfg.fmt.name, cfg.acc, cfg.mode)
        if key not in seen:
            seen.add(key)
            out.append(_mk(cfg))

    for fmt in formats:
        if isinstance(fmt, PositFormat):
            # calibration samples are captured as decoded *floats*; replaying
            # them through a posit config would misread them as int32 bit
            # patterns, so refuse rather than score garbage
            raise ValueError(
                f"posit format {fmt.name!r} is not searchable yet: "
                "candidate evaluation replays float samples")
        if include_native:
            push(GemmConfig(fmt, None, "native"))
        lsb_floor = profile.lsb_exact(fmt.precision)
        for w in sorted(widths):
            lsb = msb + ovf + 1 - w
            lsb = max(lsb, lsb_floor)          # prune: deeper is free of info
            if lsb > msb:
                continue                       # width too small for this msb
            push(GemmConfig(fmt, AccumulatorSpec(ovf=ovf, msb=msb, lsb=lsb),
                            fdp_mode))

    if include_paper91:
        push(GemmConfig(FP32, AccumulatorSpec.paper_91bit(), fdp_mode))
    return out


@dataclasses.dataclass(frozen=True)
class QuantCandidate:
    """One block-scaled format for an aux (state/collective) site, with its
    modeled byte cost at the site's traced element count."""

    cfg: QuantConfig
    bytes_total: float

    @property
    def tag(self) -> str:
        return self.cfg.tag()

    def describe(self) -> str:
        return f"{self.tag} ({self.bytes_total:.2e} B)"


def enumerate_quant_candidates(
        profile: SiteProfile, *,
        bits: Sequence[int] = QUANT_BITS,
        blocks: Sequence[int] = QUANT_BLOCKS,
        include_fp32: bool = True,
        error_feedback: bool = False) -> list[QuantCandidate]:
    """The pruned block-scaled grid for one aux site.

    The site's observed value range spans ``spread`` octaves (a_exp_max -
    a_exp_min), and a per-block exponent already absorbs the cross-block
    part of it, so payload widths beyond ``spread + 2`` bits collapse onto
    the narrowest sufficient point. Blocks wider than the site's element
    count are dropped.
    """
    ea, eb = profile.a_exp_max, profile.a_exp_min
    spread = (ea - eb) if (ea is not None and eb is not None) else None
    n = max(int(profile.macs), 1)            # macs == elements for aux sites
    all_blocks = sorted(set(int(x) for x in blocks))
    usable = [blk for blk in all_blocks if blk <= n] or all_blocks[:1]
    out, seen = [], set()
    for b in sorted(set(int(x) for x in bits)):
        if spread is not None:
            b = min(b, max(2, spread + 2))
        for blk in usable:
            cfg = QuantConfig(bits=b, block=blk,
                              error_feedback=error_feedback)
            if cfg in seen:
                continue
            seen.add(cfg)
            out.append(QuantCandidate(cfg, quant_bytes(n, cfg)))
    if include_fp32:
        cfg = FP32_STATE
        if cfg not in seen:
            out.append(QuantCandidate(cfg, quant_bytes(n, cfg)))
    return out
