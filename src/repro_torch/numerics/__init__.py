# Per-site numerical tailoring (counterpart of ``repro.numerics``), the
# paper's Fig. 3 design-space sweep run per model:
#   trace      - calibration mode: every dispatched GEMM reports its operand
#                statistics (shapes, exponent ranges, cancellation, calls)
#                and one operand sample per site into a CalibrationTrace,
#                through dispatch's trace-hook seam
#   candidates - per-site (format x AccumulatorSpec x backend) grid, pruned
#                by the exponent ranges observed in the trace
#   search     - Pareto frontier over (correct bits vs a bit-exact FDP
#                oracle, modeled energy, optional measured latency) and a
#                greedy per-site assignment meeting an error budget
#   plan       - the serializable PrecisionPlan (JSON, versioned) that loads
#                into a NumericsPolicy (--precision-plan)
#
# The recipe (CPU: device="cpu", where FDP candidates run the plain version;
# on a card the defaults, where they launch the dense FDP kernel):
#   with calibrate() as trace, use_policy(MXU_FP32): <forward and backward>
#   trace.save(path); plan = search(load_trace(path), budget_bits).plan
#   plan.save("plan.json"); serve with --precision-plan plan.json
# ``search(validators=build_validators(names, ctx))`` holds the plan to the
# workloads end to end (``repro_torch.workloads``); the latency column is
# timed without plan autotuning.
from .trace import (ENVELOPE_VERSION, TRACE_VERSION, CalibrationTrace,
                    SiteProfile, build_envelope, calibrate, cfg_capacity,
                    config_fingerprint, load_trace)
from .candidates import (Candidate, QuantCandidate, enumerate_candidates,
                         enumerate_quant_candidates)
from .search import (Evaluated, SearchResult, evaluate_candidates,
                     evaluate_quant_candidates, pareto_frontier, search)
from .plan import PLAN_VERSION, PrecisionPlan, SitePlan, load_plan

__all__ = [
    "ENVELOPE_VERSION", "TRACE_VERSION", "CalibrationTrace", "SiteProfile",
    "build_envelope", "calibrate", "cfg_capacity", "config_fingerprint",
    "load_trace",
    "Candidate", "QuantCandidate", "enumerate_candidates",
    "enumerate_quant_candidates", "evaluate_quant_candidates",
    "Evaluated", "SearchResult", "evaluate_candidates", "pareto_frontier",
    "search",
    "PLAN_VERSION", "PrecisionPlan", "SitePlan", "load_plan",
]
