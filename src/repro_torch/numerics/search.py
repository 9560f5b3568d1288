"""Pareto search over the per-site tailoring space + greedy budget assignment
(counterpart of ``repro.numerics.search``).

Per site, every candidate from ``enumerate_candidates`` is *replayed* on the
operand sample captured during calibration and scored on three axes:

  * ``error_bits``: median correct bits vs a bit-exact FDP oracle (the
    site's trace-sized ``exact_spec`` accumulator run through the simulate
    backend: exact accumulation of the f32 sample, one rounding at read-out),
  * ``energy_j``: the calibrated VU3P power model at the candidate's
    datapath, times the site's traced MAC count (modeled, as everywhere),
  * ``latency_us``: optional, the measured time of the dispatched call at
    the site's dominant traced shape when ``measure_latency=True``.

The assignment is the classic greedy: per site, the cheapest Pareto-optimal
candidate whose error meets the (margin-adjusted) budget; then, if the
workload zoo (``validators``) or an end-to-end ``validate`` hook is supplied
and the assembled policy misses, the weakest eligible site is upgraded
along its frontier until it passes.

Candidates run through the real dispatch path on the search's device (CUDA
unless the caller asks otherwise): a ``pallas`` candidate launches the dense
FDP kernel there, as the deployed plan will.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dispatch, energy, qformat
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import GemmConfig, NumericsPolicy
from repro_torch.core.formats import FP32
from repro_torch.core.metrics import correct_bits
from repro_torch.device import resolve_device

from .candidates import (DEFAULT_FORMATS, DEFAULT_WIDTHS, Candidate,
                         QuantCandidate, enumerate_candidates,
                         enumerate_quant_candidates)
from .plan import PrecisionPlan, SitePlan
from .trace import CalibrationTrace, SiteProfile, build_envelope

ERROR_CAP_BITS = 24.0          # f32 read-out: "exact" caps at full mantissa

# Per-element correct bits an aux (state/collective) site must keep on its
# calibration sample for its initial assignment: the 8-bit block-scaled
# point qualifies while 4-bit does not.
AUX_TARGET_BITS = 5.0


def _default_fdp_mode(dev: torch.device) -> str:
    """FDP candidates launch the dense kernel on a card, so that a default
    search there scores, and emits, what a deployed plan runs; elsewhere the
    plain version (the reference's default)."""
    return "pallas" if dev.type == "cuda" else "simulate"


def _check_full_fp32(dev: torch.device) -> None:
    """Native candidates (and the workloads' native sites) are scored
    through cuBLAS on a card; with TF32 an fp32 GEMM keeps ~10 fraction bits
    and the picks change. Refuse rather than switch it off behind the
    caller's back."""
    if dev.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                               or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "native fp32 GEMMs are scored with full-fp32 matmuls: "
            "set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') first")


@dataclasses.dataclass(frozen=True)
class Evaluated:
    """A candidate with its measured position in the objective space."""

    candidate: Candidate                   # Candidate | QuantCandidate
    error_bits: float
    energy_j: float
    latency_us: Optional[float] = None
    bytes_total: Optional[float] = None    # aux sites: modeled resident/wire

    @property
    def cfg(self):
        return self.candidate.cfg

    def describe(self) -> str:
        lat = f" {self.latency_us:.0f}us" if self.latency_us else ""
        by = f" {self.bytes_total:.2e} B" if self.bytes_total else ""
        return (f"{self.candidate.tag:40s} {self.error_bits:5.1f} bits  "
                f"{self.energy_j:.3e} J{lat}{by}")


def _apply_cfg(cfg: GemmConfig, a, b, site: str = "eval"):
    """Run one GEMM through the real dispatch path under a single-config
    policy: candidate evaluation and plan deployment share every code path,
    so a reloaded plan reproduces the evaluated outputs bit for bit."""
    return dispatch.gemm(a, b, site=site, policy=NumericsPolicy(cfg))


def oracle_output(profile: SiteProfile, a, b) -> np.ndarray:
    """The site's bit-exact FDP oracle on the sample: trace-sized exact
    accumulator through the simulate backend."""
    cfg = GemmConfig(FP32, profile.exact_spec(FP32.precision), "simulate")
    return _apply_cfg(cfg, a, b, site=profile.site).cpu().numpy()


def _measure_latency_us(cfg: GemmConfig, profile: SiteProfile, device=None) -> float:
    """Best-of-2 wall time, after a warm call, of the dispatched call at the
    site's *dominant traced shape* (operands from a seeded generator on the
    device: the tiny calibration sample would only measure dispatch
    overhead). Pallas candidates autotune their plan first, so the call
    times the measured launch. On a card the clock is read around
    ``synchronize``."""
    dev = resolve_device(device)
    (_, m, n, k), _count = max(profile.shapes.items(), key=lambda kv: kv[1])
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    if cfg.mode == "pallas":
        dispatch.plan_gemm(m, n, k, fmt=cfg.fmt, spec=cfg.acc, backend=dev.type,
                           autotune=True)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    fn = lambda: _apply_cfg(cfg, a, b, profile.site)
    fn()                                              # warm
    sync()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def evaluate_candidates(profile: SiteProfile,
                        candidates: Sequence[Candidate], *,
                        measure_latency: bool = False,
                        device=None) -> list[Evaluated]:
    """Replay each candidate on the site's captured sample, moved to the
    device, and score it."""
    if profile.sample is None:
        raise ValueError(f"site {profile.site!r} has no captured sample "
                         "(was it traced under calibrate()?)")
    dev = resolve_device(device)
    _check_full_fp32(dev)
    a = torch.as_tensor(profile.sample_a, device=dev)
    b = torch.as_tensor(profile.sample_b, device=dev)
    ref = oracle_output(profile, a, b)
    out = []
    for c in candidates:
        got = _apply_cfg(c.cfg, a, b, site=profile.site)
        bits = float(np.median(correct_bits(got, ref, cap=ERROR_CAP_BITS)))
        e = energy.gemm_power(c.cfg.fmt, c.cfg.acc).energy_joules(profile.macs)
        lat = (_measure_latency_us(c.cfg, profile, dev)
               if measure_latency else None)
        out.append(Evaluated(c, bits, e, lat))
    return out


def evaluate_quant_candidates(profile: SiteProfile,
                              candidates: Sequence[QuantCandidate]
                              ) -> list[Evaluated]:
    """Round-trip the aux site's captured value sample through each
    block-scaled format and score per-element correct bits against the
    original values. Energy stays 0 (no MACs run here): for aux sites the
    cost axis is ``bytes_total``, the Pareto twin of modeled joules. The
    sample is a few thousand host values, so this runs on the host."""
    if profile.sample_a is None:
        raise ValueError(f"aux site {profile.site!r} has no captured sample "
                         "(was it profiled via record_aux?)")
    x = torch.as_tensor(profile.sample_a, dtype=torch.float32)
    ref = profile.sample_a.astype(np.float32)
    out = []
    for c in candidates:
        got = qformat.quantize_roundtrip(x, c.cfg)
        bits = float(np.median(correct_bits(got, ref, cap=ERROR_CAP_BITS)))
        out.append(Evaluated(c, bits, 0.0, bytes_total=c.bytes_total))
    return out


def pareto_frontier(points: Sequence[Evaluated]) -> list[Evaluated]:
    """Non-dominated subset: maximize error_bits, minimize energy (plus
    latency when measured, and bytes on aux sites), sorted by ascending
    cost (energy, then bytes)."""

    def dominates(x: Evaluated, y: Evaluated) -> bool:
        ge = (x.error_bits >= y.error_bits and x.energy_j <= y.energy_j)
        gt = (x.error_bits > y.error_bits or x.energy_j < y.energy_j)
        if x.latency_us is not None and y.latency_us is not None:
            ge = ge and x.latency_us <= y.latency_us
            gt = gt or x.latency_us < y.latency_us
        if x.bytes_total is not None and y.bytes_total is not None:
            ge = ge and x.bytes_total <= y.bytes_total
            gt = gt or x.bytes_total < y.bytes_total
        return ge and gt

    front = [p for p in points
             if not any(dominates(q, p) for q in points if q is not p)]
    return sorted(front, key=lambda p: (p.energy_j, p.bytes_total or 0.0,
                                        -p.error_bits))


@dataclasses.dataclass
class SiteDecision:
    site: str
    profile: SiteProfile
    frontier: list[Evaluated]          # ascending energy
    chosen: int                        # index into frontier

    @property
    def pick(self) -> Evaluated:
        return self.frontier[self.chosen]

    def _next_better(self):
        """Index of the cheapest later frontier point with strictly more
        correct bits. With a latency axis the frontier is not monotone in
        error along the energy sort, so an upgrade must be accuracy-guarded
        or it could walk to a worse point."""
        for i in range(self.chosen + 1, len(self.frontier)):
            if self.frontier[i].error_bits > self.pick.error_bits:
                return i
        return None

    def can_upgrade(self) -> bool:
        return self._next_better() is not None

    def upgrade(self) -> None:
        nxt = self._next_better()
        assert nxt is not None
        self.chosen = nxt


@dataclasses.dataclass
class SearchResult:
    plan: PrecisionPlan
    decisions: dict[str, SiteDecision]
    validated_bits: Optional[float]
    # workload name -> ValidationReport when validators= drove the search
    reports: Optional[dict] = None

    def describe(self) -> str:
        lines = [f"precision plan {self.plan.name!r} "
                 f"(budget {self.plan.budget_bits} bits)"]
        for site, d in sorted(self.decisions.items()):
            p = d.pick
            lines.append(f"  {site:14s} -> {p.candidate.tag:40s} "
                         f"{p.error_bits:5.1f} bits  {p.energy_j:.3e} J")
        m = self.plan.meta
        lines.append(f"  modeled energy {m['modeled_energy_j']:.3e} J vs "
                     f"uniform 91-bit {m['baseline_energy_j']:.3e} J "
                     f"({m['energy_vs_baseline']:.1%})")
        if self.reports:
            for name in sorted(self.reports):
                lines.append("  workload " + self.reports[name].describe())
            ups = m.get("validation_upgrades", [])
            if ups:
                lines.append(f"  validator-driven upgrades: {', '.join(ups)}")
        elif self.validated_bits is not None:
            lines.append(f"  end-to-end validated: {self.validated_bits:.1f} "
                         "correct bits vs oracle")
        return "\n".join(lines)


def search(trace: CalibrationTrace, budget_bits: float, *,
           name: str = "tailored",
           default: Optional[GemmConfig] = None,
           formats: Sequence = DEFAULT_FORMATS,
           widths: Sequence[int] = DEFAULT_WIDTHS,
           fdp_mode: Optional[str] = None,
           include_native: bool = True,
           include_paper91: bool = True,
           margin_bits: float = 2.0,
           measure_latency: bool = False,
           validate: Optional[Callable[[NumericsPolicy], float]] = None,
           validators: Optional[Sequence] = None,
           max_upgrades: int = 16,
           phases: Sequence[str] = ("fwd", "bwd"),
           upgrade_phases: Sequence[str] = ("fwd",),
           aux_target_bits: float = AUX_TARGET_BITS,
           device=None) -> SearchResult:
    """Greedy per-site assignment meeting ``budget_bits`` end-to-end correct
    bits at minimum modeled energy, evaluated on ``device`` (CUDA unless the
    caller asks otherwise; on a card TF32 must be off, or this raises).
    ``fdp_mode`` None is ``"pallas"`` on a card (the FDP candidates launch
    the dense kernel, and the plan deploys it) and ``"simulate"`` elsewhere.

    ``phases`` restricts which site namespaces are searched: a trace
    calibrated through a backward carries phase-qualified backward sites
    (``attn_qk@bwd.dA``) alongside the forward ones, and each traced phase
    gets its own per-site assignment. Unassigned bwd sites fall to the
    emitted plan's widened ``bwd_default``.

    Aux sites (``opt.m@state`` / ``grad_psum@coll``, profiled via
    ``record_aux``) are searched alongside: their candidate grid is the
    block-scaled quant formats, their cost axis is *bytes*, and the initial
    pick is the fewest-bytes frontier point holding ``aux_target_bits`` on
    the calibration sample.

    End-to-end validation comes in two flavors:

    * ``validators``: a sequence of ``repro_torch.workloads`` Validators
      (``run(policy) -> ValidationReport``). All of them run on the
      assembled policy; while any reports below its threshold, the upgrade
      loop spends one Pareto-frontier upgrade per iteration on the weakest
      site that failing workload says it can see (its report's
      ``site_attribution`` patterns, else the validator's declared phases):
      a loss-gradient workload drives ``@bwd`` upgrades while a logit probe
      drives forward ones. Every report lands in ``plan.meta["validation"]``
      (and the upgrade log in ``meta["validation_upgrades"]``), so the plan
      carries the per-workload evidence it was accepted on.
    * ``validate``: the legacy scalar hook, mapping a policy to measured
      end-to-end correct bits; while it reports less than the budget, the
      weakest site whose phase is in ``upgrade_phases`` is upgraded
      (forward-only by default, since a forward validator cannot see bwd
      assignments).

    ``max_upgrades`` caps either loop. Passing both flavors is an error.
    """
    phases = tuple(phases)
    if validate is not None and validators:
        raise ValueError("pass either validate= (legacy scalar hook) or "
                         "validators= (workload zoo), not both")
    dev = resolve_device(device)
    _check_full_fp32(dev)
    fdp_mode = fdp_mode or _default_fdp_mode(dev)
    all_profiles = trace.profiles()
    profiles = {s: p for s, p in all_profiles.items()
                if qformat.site_kind(s) == "gemm"
                and p.sample is not None
                and dispatch.GemmSite.parse(s).phase in phases}
    # aux (state/collective) profiles ride along whenever the trace carries
    # them: they have no phase namespace to restrict by.
    aux_profiles = {s: p for s, p in all_profiles.items()
                    if qformat.site_kind(s) != "gemm"
                    and p.sample_a is not None}
    if not profiles:
        raise ValueError(
            f"trace has no calibrated sites with samples in phases {phases}")

    decisions: dict[str, SiteDecision] = {}
    site_target = budget_bits + margin_bits
    for site, prof in sorted(profiles.items()):
        cands = enumerate_candidates(prof, formats=formats, widths=widths,
                                     fdp_mode=fdp_mode,
                                     include_native=include_native,
                                     include_paper91=include_paper91)
        evaluated = evaluate_candidates(prof, cands, device=dev,
                                        measure_latency=measure_latency)
        frontier = pareto_frontier(evaluated)
        chosen = next((i for i, p in enumerate(frontier)
                       if p.error_bits >= site_target), len(frontier) - 1)
        decisions[site] = SiteDecision(site, prof, frontier, chosen)
    for site, prof in sorted(aux_profiles.items()):
        # searched assignments are the stateless formats; error feedback is a
        # deployment choice layered on top
        cands = enumerate_quant_candidates(prof)
        frontier = pareto_frontier(evaluate_quant_candidates(prof, cands))
        chosen = next((i for i, p in enumerate(frontier)
                       if p.error_bits >= aux_target_bits), len(frontier) - 1)
        decisions[site] = SiteDecision(site, prof, frontier, chosen)

    def assemble() -> PrecisionPlan:
        return _plan_from_decisions(name, decisions, budget_bits, default)

    validated = None
    reports = upgrades_log = None
    if validate is not None:
        up_phases = tuple(upgrade_phases)
        for _ in range(max_upgrades + 1):
            validated = float(validate(assemble().to_policy()))
            if validated >= budget_bits:
                break
            upgradable = [
                d for d in decisions.values() if d.can_upgrade()
                and qformat.site_kind(d.site) == "gemm"
                and dispatch.GemmSite.parse(d.site).phase in up_phases]
            if not upgradable:
                break
            weakest = min(upgradable, key=lambda d: d.pick.error_bits)
            weakest.upgrade()
    elif validators:
        reports, upgrades_log = _run_validator_loop(
            validators, decisions, assemble, max_upgrades)

    plan = assemble()
    if validated is not None:
        plan.meta["validated_bits"] = validated
    if reports is not None:
        plan.meta["validation"] = {n: r.to_json()
                                   for n, r in sorted(reports.items())}
        plan.meta["validation_upgrades"] = list(upgrades_log)
        # validated_bits keeps its meaning, end-to-end forward correct bits
        # vs the uniform oracle: the logit-fidelity workload's score. Other
        # workloads score in other units (repro caps at 53 stability bits),
        # so absent logits it stays unset.
        if "logits" in reports:
            validated = reports["logits"].score
            plan.meta["validated_bits"] = validated
    if getattr(trace, "fingerprint", None):
        # provenance: which persisted calibration this plan was searched from
        plan.meta["trace_fingerprint"] = trace.fingerprint
    # the runtime-checkable boundary of this plan's claims: traced per-site
    # exponent ranges + the deployed capacity
    plan.meta["envelope"] = build_envelope(trace, plan)
    return SearchResult(plan, decisions, validated, reports=reports)


def _run_validator_loop(validators, decisions, assemble, max_upgrades):
    """Run the workload zoo on the assembled policy, spending Pareto-frontier
    upgrades on sites the *failing* workloads attribute their deficit to.

    One upgrade per iteration (the first failing validator in the caller's
    order picks the weakest eligible site), and EVERY validator re-runs on
    every iteration: an upgrade raises one site's accuracy but can regress an
    orthogonal workload (a cheap bit-stable FDP point upgraded onto a
    more-accurate native one loses K-reorder stability), so previously
    passing reports cannot be assumed to stand. The loop always exits with
    reports measured against the exact policy that ships.
    """
    reports: dict = {}
    upgrades_log: list[str] = []
    while True:
        policy = assemble().to_policy()
        for v in validators:
            reports[v.name] = v.run(policy)
        failing = [v for v in validators if not reports[v.name].passed]
        if not failing or len(upgrades_log) >= max_upgrades:
            break
        target = None
        for v in failing:
            rep = reports[v.name]
            eligible = [d for d in decisions.values() if d.can_upgrade()
                        and v.eligible_site(d.site, rep)]
            if eligible:
                # weakest first: by the workload's own per-site attribution
                # when it names exact sites, else by the search-time oracle
                target = min(eligible, key=lambda d: rep.site_attribution.get(
                    d.site, d.pick.error_bits))
                break
        if target is None:
            break                      # failing, but nothing left to widen
        target.upgrade()
        upgrades_log.append(target.site)
    return reports, upgrades_log


def _plan_from_decisions(name, decisions, budget_bits,
                         default: Optional[GemmConfig]) -> PrecisionPlan:
    sites = []
    modeled = baseline = 0.0
    by_phase = {"fwd": 0.0, "bwd": 0.0}
    total_macs = 0
    # bytes Pareto axes: resident (state sites) and moved (collective sites),
    # each against the fp32 carrier of the same element count.
    bytes_axes = {"state": [0.0, 0.0], "collective": [0.0, 0.0]}
    base_power = energy.gemm_power(FP32, AccumulatorSpec.paper_91bit())
    for site, d in sorted(decisions.items()):
        p = d.pick
        kind = qformat.site_kind(site)
        sites.append(SitePlan(site=site, cfg=p.cfg, kind=kind,
                              error_bits=p.error_bits, energy_j=p.energy_j,
                              macs=d.profile.macs, latency_us=p.latency_us,
                              bytes_total=p.bytes_total))
        if kind == "gemm":
            modeled += p.energy_j
            by_phase[dispatch.GemmSite.parse(site).phase] += p.energy_j
            baseline += base_power.energy_joules(d.profile.macs)
            total_macs += d.profile.macs
        else:
            bytes_axes[kind][0] += p.bytes_total or 0.0
            bytes_axes[kind][1] += 4.0 * d.profile.macs
    meta = {
        "modeled_energy_j": modeled,
        "modeled_energy_fwd_j": by_phase["fwd"],
        "modeled_energy_bwd_j": by_phase["bwd"],
        "baseline_energy_j": baseline,
        "energy_vs_baseline": modeled / baseline if baseline else None,
        "total_macs": total_macs,
    }
    for kind, key in (("state", "bytes_resident"), ("collective",
                                                    "bytes_moved")):
        got, fp32 = bytes_axes[kind]
        if fp32:
            meta[key] = got
            meta[f"{key}_fp32"] = fp32
            meta[f"{key}_vs_fp32"] = got / fp32
    default = default or GemmConfig()
    return PrecisionPlan(name=name, sites=tuple(sites),
                         default=default,
                         bwd_default=dispatch.widen_config(default),
                         budget_bits=budget_bits, meta=meta)
