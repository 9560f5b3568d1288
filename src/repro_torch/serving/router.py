"""PlanRouter: workload-conditional plan selection over the plan zoo
(counterpart of ``repro.serving.router``).

The MANIFEST records, for every plan, the per-workload validation scores the
workload zoo earned it (solve/grad/repro/logits) plus the modeled-energy
bookkeeping. This module turns that recorded evidence into a request-time
routing table: a request declares a *workload class* — ``chat`` (cheapest
passing plan), ``solve`` (highest solve-workload score; FDP-wide numerics),
``repro`` (bit-stable replies: repro-certified plans only) — or an explicit
plan name, plus optional constraints (minimum validated bits,
bit-stability), and the router answers with a concrete ``RoutedPlan`` whose
``policy()`` the engine pool captures under. Requests whose constraints no
plan satisfies get a typed ``RoutingError``, never a silent fallback.

Derived variants
----------------
``from_manifest(..., derive=True)`` registers, next to each tailored plan,
two derived variants whose numerics come from the plan document itself, in
the reference's ``simulate`` mode (``pallas`` gives the same bits on the
card, but a variant in another mode would be another feature):

``<name>/fdp91``
    The paper's flagship uniform numerics (fp32 operands through the
    ⟨30,30,-30⟩ 91-bit FDP, ``dispatch.FDP91``) — the solve-class oracle.
    Bit-stable by construction, at baseline energy (1.0).

``<name>/repro``
    The plan default's serving format through the same 91-bit wrap
    accumulator, ``simulate`` everywhere: reorder-exact with the cheap
    multiplier, its energy from ``core.energy.gemm_power``.

A ``RoutedPlan`` built by hand (a ``loader`` returning any policy, such as
the kernel policy ``launch.serve.FDP91_KERNEL``, and the evidence measured
for it) routes like a MANIFEST entry.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Sequence, Union

from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import FDP91, GemmConfig, NumericsPolicy
from repro_torch.core.energy import gemm_power
from repro_torch.core.formats import FP32

WORKLOAD_CLASSES = ("chat", "solve", "repro")

# Bit-exact FDP accumulation scores at the f64-reference measurement cap in
# the workload zoo (the repro workload probes against float64); a recorded
# repro score at/above REPRO_CERT_BITS certifies bit-stability under
# reordering.
FDP_CAP_BITS = 53.0
REPRO_CERT_BITS = 50.0


class RoutingError(ValueError):
    """No plan satisfies the request's workload class + constraints.
    ``workload`` names the class (or explicit plan) that failed to route,
    ``reason`` says why — the typed rejection the frontend surfaces."""

    def __init__(self, workload: str, reason: str):
        super().__init__(f"cannot route {workload!r}: {reason}")
        self.workload = workload
        self.reason = reason


def _numeric(x) -> Optional[float]:
    """A score usable for routing: a real, finite number or None."""
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return None
    if x != x or x in (float("inf"), float("-inf")):
        return None
    return float(x)


@dataclasses.dataclass
class RoutedPlan:
    """One routable entry: recorded per-workload evidence plus a lazy policy
    source (a plan path, or a loader callable)."""

    name: str
    arch: Optional[str] = None
    scores: dict = dataclasses.field(default_factory=dict)   # workload -> bits
    passed: dict = dataclasses.field(default_factory=dict)   # workload -> bool
    energy: float = 1.0                # energy_vs_baseline (1.0 = FDP91-wide)
    validated_bits: Optional[float] = None
    repro_certified: bool = False
    derived: Optional[str] = None      # "fdp91" | "repro" | None (zoo plan)
    path: Optional[str] = None
    loader: Optional[Callable[[], NumericsPolicy]] = None
    _policy: Optional[NumericsPolicy] = dataclasses.field(default=None, repr=False)

    def policy(self) -> NumericsPolicy:
        """Resolve (and cache) the NumericsPolicy this entry deploys."""
        if self._policy is None:
            if self.loader is not None:
                self._policy = self.loader()
            elif self.path is not None:
                from repro_torch.core.dispatch import policy_from_plan
                self._policy = policy_from_plan(self.path)
            else:
                raise RoutingError(self.name, "entry has no policy source (path or loader)")
        return self._policy

    def unsatisfied(self, min_bits: Optional[float], bit_stable: bool) -> Optional[str]:
        """Why this plan fails the request's constraints (None = satisfies)."""
        if min_bits is not None:
            got = _numeric(self.validated_bits)
            if got is None or got < min_bits:
                return f"validated_bits={self.validated_bits} < required {min_bits}"
        if bit_stable and not self.repro_certified:
            return "not repro-certified (replies not bit-stable)"
        return None

    def all_passed(self) -> bool:
        return bool(self.passed) and all(self.passed.values())


class PlanRouter:
    """Index the recorded evidence; answer workload-class routes."""

    def __init__(self, plans: Sequence[RoutedPlan]):
        self._plans = list(plans)
        self._by_name = {}
        for p in self._plans:
            if p.name in self._by_name:
                raise ValueError(f"duplicate routable plan name {p.name!r}")
            if p.name in WORKLOAD_CLASSES:
                raise ValueError(f"plan name {p.name!r} shadows a workload class")
            self._by_name[p.name] = p
        if not self._plans:
            raise ValueError("router needs at least one routable plan")

    @property
    def plans(self) -> tuple:
        return tuple(self._plans)

    def names(self) -> tuple:
        return tuple(p.name for p in self._plans)

    def __getitem__(self, name: str) -> RoutedPlan:
        return self._by_name[name]

    def get(self, name: str) -> Optional[RoutedPlan]:
        return self._by_name.get(name)

    # -- selection ---------------------------------------------------------
    def route(self, workload: str = "chat", *, min_bits: Optional[float] = None,
              bit_stable: bool = False) -> RoutedPlan:
        """Map (workload class | explicit plan name) + constraints to a
        concrete plan; raise ``RoutingError`` when nothing satisfies."""
        if workload in self._by_name:           # explicit plan name wins
            plan = self._by_name[workload]
            reason = plan.unsatisfied(min_bits, bit_stable)
            if reason:
                raise RoutingError(workload, reason)
            return plan
        if workload not in WORKLOAD_CLASSES:
            raise RoutingError(
                workload, f"unknown workload class / plan name; classes are "
                          f"{WORKLOAD_CLASSES}, plans are {self.names()}")

        cands, rejects = [], []
        for p in self._plans:
            reason = p.unsatisfied(min_bits, bit_stable)
            (rejects if reason else cands).append((p, reason))
        cands = [p for p, _ in cands]

        if workload == "repro":
            # bit-stable replies: repro-certified entries only, cheapest
            # first, strongest repro score on ties
            cands = [p for p in cands if p.repro_certified]
            if not cands:
                raise RoutingError(workload, self._why_empty(
                    rejects, "no repro-certified plan in the zoo"))
            return min(cands, key=lambda p: (p.energy, -(p.scores.get("repro") or 0.0),
                                             p.name))

        if workload == "solve":
            # accuracy-critical dots/systems: highest recorded solve score,
            # cheapest on ties
            scored = [(p, _numeric(p.scores.get("solve"))) for p in cands]
            scored = [(p, s) for p, s in scored if s is not None]
            if not scored:
                raise RoutingError(workload, self._why_empty(
                    rejects, "no plan records a solve-workload score"))
            return min(scored, key=lambda ps: (-ps[1], ps[0].energy, ps[0].name))[0]

        # chat: cheapest plan whose recorded validations all passed
        cands = [p for p in cands if p.all_passed()]
        if not cands:
            raise RoutingError(workload, self._why_empty(
                rejects, "no plan with all validations passing"))
        return min(cands, key=lambda p: (p.energy, -(_numeric(p.validated_bits) or 0.0),
                                         p.name))

    @staticmethod
    def _why_empty(rejects, fallback: str) -> str:
        if rejects:
            detail = "; ".join(f"{p.name}: {r}" for p, r in rejects[:4])
            return f"{fallback} (constraint rejections: {detail})"
        return fallback

    # -- construction from the zoo ------------------------------------------
    @classmethod
    def from_manifest(cls, plans_dir: Union[str, os.PathLike], arch: Optional[str] = None,
                      derive: bool = True) -> "PlanRouter":
        """Build a router from ``<plans_dir>/MANIFEST.json``. ``arch``
        restricts to one served architecture's plans (entry key or the
        recorded ``arch`` alias); ``derive`` adds the fdp91/repro variants."""
        manifest_path = os.path.join(os.fspath(plans_dir), "MANIFEST.json")
        with open(manifest_path) as f:
            manifest = json.load(f)
        plans: list = []
        for key, entry in sorted(manifest.get("plans", {}).items()):
            if arch is not None and arch not in (key, entry.get("arch")):
                continue
            rp = routed_plan_from_entry(key, entry, os.fspath(plans_dir))
            plans.append(rp)
            if derive:
                plans.extend(derive_variants(rp))
        if not plans:
            raise RoutingError(arch or "*", f"no MANIFEST entry matches arch={arch!r} "
                                            f"in {manifest_path}")
        return cls(plans)


def routed_plan_from_entry(key: str, entry: dict, plans_dir: str) -> RoutedPlan:
    """One MANIFEST entry -> one routable plan. Raises ValueError when the
    entry is missing the routing metadata the router reads."""
    validation = entry.get("validation")
    if not isinstance(validation, dict) or not validation:
        raise ValueError(f"{key}: MANIFEST entry carries no validation "
                         "scores — the router has nothing to rank it by")
    scores, passed = {}, {}
    for w, rep in validation.items():
        score = _numeric(rep.get("score")) if isinstance(rep, dict) else None
        if score is None:
            raise ValueError(f"{key}: validation[{w!r}] score is not a finite number: {rep!r}")
        scores[w] = score
        passed[w] = bool(rep.get("passed"))
    energy = _numeric(entry.get("energy_vs_baseline"))
    if energy is None:
        raise ValueError(f"{key}: energy_vs_baseline is not numeric "
                         f"({entry.get('energy_vs_baseline')!r})")
    certified = bool(entry.get("repro_certified", (
        passed.get("repro", False) and (scores.get("repro") or 0.0) >= REPRO_CERT_BITS)))
    return RoutedPlan(
        name=key, arch=entry.get("arch"), scores=scores, passed=passed, energy=energy,
        validated_bits=_numeric(entry.get("validated_bits")), repro_certified=certified,
        path=os.path.join(plans_dir, entry.get("file", f"{key}.json")))


def derive_variants(rp: RoutedPlan) -> list:
    """The two derived serving variants of one tailored zoo plan (module
    docstring): the repro variant runs the plan *default's* format through
    the paper's 91-bit wrap accumulator."""
    from repro_torch.numerics import load_plan    # deferred: numerics imports core
    plan = load_plan(rp.path)
    spec = AccumulatorSpec.paper_91bit()
    fmt = plan.default.fmt
    repro_policy = NumericsPolicy(GemmConfig(fmt, spec, "simulate"),
                                  name=f"repro_pinned:{rp.name}")
    # modeled energy of the pinned variant relative to the FDP91 baseline:
    # same 91-bit accumulate, multiplier at the serving format's precision
    pinned = gemm_power(fmt, spec).watts / gemm_power(FP32, spec).watts
    wide = RoutedPlan(
        name=f"{rp.name}/fdp91", arch=rp.arch,
        scores={"solve": FDP_CAP_BITS, "repro": FDP_CAP_BITS, "logits": FDP_CAP_BITS},
        passed={"solve": True, "repro": True, "logits": True},
        energy=1.0, validated_bits=FDP_CAP_BITS, repro_certified=True,
        derived="fdp91", loader=lambda: FDP91)
    stable = RoutedPlan(
        name=f"{rp.name}/repro", arch=rp.arch,
        scores={"repro": FDP_CAP_BITS,
                # fidelity floor is the serving format's significand
                "logits": float(min(rp.validated_bits or FDP_CAP_BITS, fmt.precision))},
        passed={"repro": True, "logits": True},
        energy=min(1.0, pinned), validated_bits=float(fmt.precision),
        repro_certified=True, derived="repro", loader=lambda: repro_policy)
    return [wide, stable]
