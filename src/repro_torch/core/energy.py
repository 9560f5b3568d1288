"""Analytical power/energy model of the generated datapaths (a copy of
``repro.core.energy``: numpy only, kept here because the port imports
nothing of the reference).

The paper reports measured watts on a VU3P-2 FPGA @ 200 MHz:
    double-precision FMA : 0.266 W
    quad-precision  FMA  : 0.549 W
    91-bit FDP ⟨30,30,-30⟩: 0.491 W

With no synthesizer in the loop we fit a simple structural model to those
anchors and use it for every ⟨format, ovf, msb, lsb⟩ point of the Fig. 3
sweeps. Dynamic power of an arithmetic datapath is dominated by
(a) the significand multiplier — ~quadratic in significand width p — and
(b) the accumulator/alignment stage — ~linear in accumulator width W:

    P(p, W) = alpha * p^2 + beta * W + gamma        [watts @ 200 MHz]

Three anchors, three parameters (exact fit):
    fp64 FMA:  p=53, W=~106 effective (FMA rounds each step; datapath width
               is mult 2p + normalizer): P = 0.266
    fp128 FMA: p=113, W=226:            P = 0.549
    91-bit FDP (fp64 front end): p=53, W=91: P = 0.491

The FDP's extra cost vs the fp64 FMA at the same p reflects the wide
fixed-point adder + shifter — captured by a separate delta on beta for
fdp-style datapaths (the fit below). Energies are then E = P * cycles / f
with one MAC issued per cycle (the generator's II=1 pipelines).

This is a *model*, clearly labelled as such in every benchmark output; its
purpose is to preserve the paper's accuracy-vs-energy trade-off axis, not to
predict silicon. The reference model's pJ/MAC variant is kept, constants
included, so that reports compare equal to the reference's; none of its
numbers describes the card the port runs on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FREQ_HZ = 200e6


def _fit():
    # unknowns: alpha (mult, p^2), beta_fma (per datapath-width bit for FMA),
    # anchor widths: FMA datapath width ~ 2p (product) ; FDP width = W.
    # Solve with gamma shared:
    #   a*53^2  + b*106 + g = 0.266
    #   a*113^2 + b*226 + g = 0.549
    #   a*53^2  + c*91  + g = 0.491   (c = beta for FDP wide adders/shifter)
    # Underdetermined (4 unknowns, 3 eqs): pin gamma = 0.05 W (static/clock
    # tree floor, typical for small VU3P designs).
    g = 0.05
    A = np.array([[53.0**2, 106.0], [113.0**2, 226.0]])
    y = np.array([0.266 - g, 0.549 - g])
    alpha, beta = np.linalg.solve(A, y)
    c = (0.491 - g - alpha * 53.0**2) / 91.0
    return float(alpha), float(beta), float(c), g


ALPHA, BETA_FMA, BETA_FDP, GAMMA = _fit()


@dataclasses.dataclass(frozen=True)
class PowerReport:
    watts: float
    alpha_term: float
    beta_term: float
    gamma: float
    kind: str

    def energy_joules(self, n_macs: int, macs_per_cycle: int = 1) -> float:
        cycles = n_macs / macs_per_cycle
        return self.watts * cycles / FREQ_HZ


def fma_power(precision: int) -> PowerReport:
    """Conventional FMA unit power (paper baseline). precision = significand
    bits incl. implicit (24 fp32, 53 fp64, 113 fp128)."""
    a = ALPHA * precision**2
    b = BETA_FMA * (2 * precision)
    return PowerReport(a + b + GAMMA, a, b, GAMMA, f"fma_p{precision}")


def fdp_power(precision: int, acc_width: int) -> PowerReport:
    """Tailored FDP unit power: significand multiplier at input precision +
    wide fixed-point accumulate at ``acc_width`` bits."""
    a = ALPHA * precision**2
    b = BETA_FDP * acc_width
    return PowerReport(a + b + GAMMA, a, b, GAMMA, f"fdp_p{precision}_w{acc_width}")


def spec_power(fmt, spec) -> PowerReport:
    """Power of the generated ⟨format, ovf,msb,lsb⟩ GEMM processing element."""
    return fdp_power(fmt.precision, spec.width)


def gemm_power(fmt, spec=None) -> PowerReport:
    """Power of one GEMM processing element for a dispatch-level candidate:
    ``spec=None`` is the conventional-FMA path at the format's precision
    (the MXU/native point of the design space), otherwise the tailored FDP
    at the accumulator's width. This is the per-candidate energy axis of the
    ``repro.numerics`` Pareto search."""
    return fma_power(fmt.precision) if spec is None else spec_power(fmt, spec)


# --- sanity: reproduce the paper's three calibration points ---------------
PAPER_POINTS = {
    "fp64_fma": (fma_power(53).watts, 0.266),
    "fp128_fma": (fma_power(113).watts, 0.549),
    "fdp91_fp64": (fdp_power(53, 91).watts, 0.491),
}


# --- the reference model's pJ/MAC variant -----------------------------------
# Model constants of the reference (its names kept for parity): pJ per
# matrix-unit MAC and per vector int32 op. The limb FDP spends ~(digits^2
# products + 2*digits*L placement + L adds) int ops per MAC. Not measured
# on, and not a figure of, any card the port runs on.
TPU_PJ_PER_MXU_MAC = 2.0
TPU_PJ_PER_VPU_OP = 0.5


def tpu_fdp_pj_per_mac(precision: int, num_limbs: int) -> float:
    digits = -(-precision // 12)
    int_ops = digits * digits + 2 * digits * num_limbs + num_limbs
    return int_ops * TPU_PJ_PER_VPU_OP
