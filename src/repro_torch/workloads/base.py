"""The workload zoo's common substrate (counterpart of
``repro.workloads.base``): the ``Validator`` protocol and its registry.

A *workload* is an end-to-end numerical scenario (an ill-conditioned solve,
a training-loss gradient, a reproducibility probe, an inference-quality
probe) that judges a ``NumericsPolicy`` the way a user of the tailored
kernels would, not the way the per-site search oracle does. Every workload
implements the same contract:

    report = validator.run(policy)          # -> ValidationReport

and a ``ValidationReport`` carries a scalar ``score`` (correct bits, unless
the validator says otherwise), the ``threshold`` it must meet, and a
``site_attribution`` map: site *patterns* (``NumericsPolicy`` override
grammar: exact keys, ``name@bwd.dA``, ``*@bwd``) scored by how that slice of
the workload fared. ``numerics.search`` upgrades only sites a *failing*
validator says it can see, so a loss-gradient validator drives ``@bwd``
upgrades while a logit probe drives forward ones.

Validators register by name (``@register``) so callers select them with
strings (``search(validators=build_validators(("grad", "logits"), ctx))``).

A ``WorkloadContext`` names the device its validators run on: CUDA unless
the caller asks for the CPU, where every GEMM runs its plain version. The
reference's ``dist`` (a ``layers.Distribution``) is left out: no validator
reads it, and the parameter placement it would carry waits for ROADMAP.md
queue 1, *Multi-device*, placement and entry points. The ``mesh``
workload runs on the ranks of a ``torch.distributed`` world instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.dispatch import GemmSite, _match_score
from repro_torch.core.qformat import site_kind
from repro_torch.device import resolve_device
from repro_torch.models.config import check_family

# The zoo-wide probe-batch shape: plans are calibrated and their evidence
# recorded on exactly this shape, and WorkloadContext.for_model defaults to
# it, so recomputed scores (python -m repro_torch.workloads --tolerance) are
# judged on the same data distribution the plan recorded.
PROBE_BATCH, PROBE_SEQ, PROBE_SEED = 2, 8, 0

# the per-workload keys a MANIFEST entry summarizes out of a full report
SUMMARY_KEYS = ("score", "threshold", "units", "passed")


def validation_summary(meta: dict) -> dict:
    """Compact per-workload score summary of a plan's ``meta.validation``
    (full reports, with attribution and details, stay in the plan)."""
    return {name: {k: rep.get(k) for k in SUMMARY_KEYS}
            for name, rep in sorted((meta.get("validation") or {}).items())}


@dataclasses.dataclass
class ValidationReport:
    """One workload's verdict on one policy."""

    workload: str
    score: float                      # in ``units``; higher is better
    threshold: float                  # pass iff score >= threshold
    units: str = "bits"
    # site pattern -> score for the slice of the workload that pattern
    # dominates (exact site keys when the workload probes sites one by one,
    # namespace wildcards like "*@bwd" when it can only see a phase).
    site_attribution: dict = dataclasses.field(default_factory=dict)
    details: dict = dataclasses.field(default_factory=dict)
    # the device-mesh shape(s) this validation ran under; None = one device
    mesh: Optional[str] = None

    @property
    def passed(self) -> bool:
        return self.score >= self.threshold

    def to_json(self) -> dict:
        def _f(v):
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            if isinstance(v, float) and not math.isfinite(v):
                return None
            return v

        out = {
            "workload": self.workload,
            "score": _f(float(self.score)),
            "threshold": _f(float(self.threshold)),
            "units": self.units,
            "passed": bool(self.passed),
            "site_attribution": {k: _f(float(v))
                                 for k, v in self.site_attribution.items()},
            "details": {k: _f(v) for k, v in self.details.items()},
        }
        if self.mesh is not None:
            out["mesh"] = str(self.mesh)
        return out

    def describe(self) -> str:
        verdict = "pass" if self.passed else "FAIL"
        return (f"{self.workload:14s} {self.score:6.1f} {self.units} "
                f"(>= {self.threshold:g}: {verdict})")


class Validator:
    """Base class for workload validators.

    Subclasses set ``name`` (registry key), ``phases`` (which site namespaces
    the score is sensitive to: the upgrade loop's fallback when a report
    carries no site attribution) and implement ``run``.
    """

    name: str = "?"
    phases: tuple = ("fwd",)
    threshold: float = 0.0

    def run(self, policy) -> ValidationReport:
        raise NotImplementedError

    # -- search integration -------------------------------------------------
    def eligible_site(self, site_key: str, report: ValidationReport) -> bool:
        """May the upgrade loop spend an upgrade on ``site_key`` to fix this
        validator's deficit? Attribution patterns win when present; else the
        validator's declared phases.

        Aux (state/collective) site keys never parse as GemmSites, so they
        match only by exact attribution key or the kind wildcards
        ``*@state`` / ``*@coll``, and only validators that *declare* the
        aux kind in ``phases`` may touch them without attribution."""
        kind = site_kind(site_key)
        if kind != "gemm":
            if report.site_attribution:
                suffix = site_key.rpartition("@")[2]
                return any(pat == site_key or pat == f"*@{suffix}"
                           for pat in report.site_attribution)
            return kind in self.phases
        site = GemmSite.parse(site_key)
        if report.site_attribution:
            gemm_pats = [p for p in report.site_attribution
                         if site_kind(p) == "gemm"]
            return any(_match_score(pat, site) is not None
                       for pat in gemm_pats)
        return site.phase in self.phases


@dataclasses.dataclass
class WorkloadContext:
    """Everything a validator may need to instantiate itself for one model.

    Synthetic workloads (solve, repro) ignore the model fields; model-bound
    ones (grad, logits, quant_opt) refuse to build without them.
    ``budget_bits`` seeds the default thresholds so ``search(budget_bits=B)``
    and its validators agree on what "good enough" means. ``params`` is a
    ``models.Transformer`` and the batches hold tensors, all on ``device``
    (CUDA unless the caller asks for another).
    """

    budget_bits: float = 10.0
    cfg: Optional[object] = None           # repro_torch.models ModelConfig
    params: Optional[object] = None
    batch: Optional[dict] = None           # forward/logit probe batch
    grad_batch: Optional[dict] = None      # batch with targets/loss_mask
    seed: int = 0
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def require_model(self, who: str) -> None:
        missing = [k for k in ("cfg", "params", "batch")
                   if getattr(self, k) is None]
        if missing:
            raise ValueError(
                f"workload {who!r} needs a model-bound context "
                f"(missing {missing}); build one with "
                "WorkloadContext.for_model(cfg, ...)")

    @classmethod
    def for_model(cls, cfg, *, budget_bits: float = 10.0,
                  seed: int = PROBE_SEED, batch_size: int = PROBE_BATCH,
                  seq: int = PROBE_SEQ, device=None) -> "WorkloadContext":
        """Self-contained model context: seeded params and probe batches of
        the same shape family the plan-zoo calibration uses, on ``device``."""
        from repro_torch.models import init

        dev = resolve_device(device)
        params = init(cfg, seed=seed, device=dev)
        batch = make_probe_batch(cfg, batch_size=batch_size, seq=seq,
                                 seed=seed + 1, device=dev)
        grad_batch = make_probe_batch(cfg, batch_size=batch_size, seq=seq,
                                      seed=seed + 1, with_targets=True,
                                      device=dev)
        return cls(budget_bits=budget_bits, cfg=cfg, params=params,
                   batch=batch, grad_batch=grad_batch, seed=seed, device=dev)


def make_probe_batch(cfg, *, batch_size: int, seq: int, seed: int,
                     with_targets: bool = False, device=None) -> dict:
    """A seeded probe batch for any config family (tokens, plus vlm
    ``patches`` or encdec ``frames`` as 0.5 x normal, plus CE targets when
    the workload differentiates), drawn on the CPU from
    ``torch.Generator(seed)`` in that order, so it is the same on every
    device, then moved to ``device``. The draws differ from ``jax.random``'s
    for the same seed; the same seed gives the same tokens, patches and
    frames with or without targets, as in the reference."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, seq),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = 0.5 * torch.randn((batch_size, cfg.n_patches, cfg.d_model),
                                             generator=gen)
    if cfg.family == "encdec":
        batch["frames"] = 0.5 * torch.randn((batch_size, cfg.enc_seq, cfg.d_model),
                                            generator=gen)
    if with_targets:
        batch["targets"] = torch.randint(0, cfg.vocab_size, (batch_size, seq),
                                         generator=gen)
        batch["loss_mask"] = torch.ones((batch_size, seq), dtype=torch.float32)
    return {k: v.to(dev) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cls):
    """Class decorator: add a Validator subclass to the zoo under its
    ``name``."""
    if not cls.name or cls.name == "?":
        raise ValueError(f"{cls.__name__} must set a registry name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate workload name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def available_workloads() -> list:
    return sorted(_REGISTRY)


def get_workload(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; available: "
                       f"{available_workloads()}") from None


def build_validators(names: Sequence[str],
                     ctx: Optional[WorkloadContext] = None):
    """Instantiate validators by registry name against one context
    (per-validator tuning goes through the class constructors directly)."""
    ctx = ctx or WorkloadContext()
    return [get_workload(n).from_context(ctx) for n in names]


def probed_sites(policy) -> list:
    """The exact (non-wildcard) site keys a policy explicitly assigns: what
    per-site workloads probe. For a deployed PrecisionPlan policy this is
    precisely the searched site list."""
    out = []
    for pat, _ in getattr(policy, "overrides", ()):
        if "*" in pat:
            continue
        try:
            site = GemmSite.parse(pat)
        except ValueError:
            continue
        if site.key == pat:
            out.append(pat)
    return out
