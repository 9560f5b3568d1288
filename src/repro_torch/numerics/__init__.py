# Per-site numerical tailoring (counterpart of ``repro.numerics``). Ported so
# far: ``plan``, the serializable PrecisionPlan (JSON, versioned) that loads
# into a NumericsPolicy with per-site overrides (``--precision-plan``). The
# calibration trace, candidate grid and search come with later slices.
from .plan import PLAN_VERSION, PrecisionPlan, SitePlan, load_plan

__all__ = ["PLAN_VERSION", "PrecisionPlan", "SitePlan", "load_plan"]
