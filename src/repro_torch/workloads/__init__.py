# repro_torch.workloads: the end-to-end scenario zoo (counterpart of
# ``repro.workloads``).
#
# The layer between the model zoo and the precision search: each workload is
# a complete numerical scenario wrapped in a common ``Validator`` protocol
# (``run(policy) -> ValidationReport``) that ``numerics.search`` consumes
# through ``search(validators=...)``: scores, pass thresholds, and per-site
# attribution the greedy upgrade loop can act on (``@bwd`` sites included).
#
#   base             - Validator / ValidationReport / registry /
#                      WorkloadContext (model binding, device) / probe batches
#   solve            - Ogita-Rump-Oishi dots + prescribed-condition linear
#                      systems vs the exact oracle (paper Fig. 2 harness)
#   gradients        - loss-gradient step vs the 91-bit-bwd reference
#   inference        - logit correct-bits + top-1 vs the uniform 91-bit FDP
#   reproducibility  - bit-stability of results under K-reduction reordering
#   quant_opt        - quantized-optimizer-state + compressed-collective
#                      training-loss curves vs the fp32-state reference
#   mesh             - bit-stability across the mesh factorizations of a
#                      torch.distributed world (K-sharded sites, and the
#                      logits and fixed-point gradients of a data-parallel
#                      step)
#
# ``python -m repro_torch.workloads --plan examples/plans/<arch>.json`` runs
# the zoo against a checked-in plan (on the card; ``--device cpu`` here).
from .base import (PROBE_BATCH, PROBE_SEED, PROBE_SEQ, SUMMARY_KEYS,
                   ValidationReport, Validator, WorkloadContext,
                   available_workloads, build_validators, get_workload,
                   make_probe_batch, probed_sites, register,
                   validation_summary)
from .gradients import LossGradient, bwd91_reference_policy
from .inference import LogitFidelity
from .mesh import MeshReshapeStability
from .quant_opt import QuantizedOptimizer
from .reproducibility import KReorderStability
from .solve import IllConditionedSolve

# the plan-zoo refresh's default gate: model-bound end-to-end validators
# (solve, mesh and quant_opt are opt-in: solve's operand ranges are
# deliberately hostile to DNN-calibrated accumulators, and mesh's sweep
# wants a world of several ranks)
DEFAULT_VALIDATORS = ("grad", "logits", "repro")

__all__ = [
    "PROBE_BATCH", "PROBE_SEED", "PROBE_SEQ", "SUMMARY_KEYS",
    "ValidationReport", "Validator", "WorkloadContext",
    "available_workloads", "build_validators", "get_workload",
    "make_probe_batch", "probed_sites", "register", "validation_summary",
    "LossGradient", "bwd91_reference_policy", "LogitFidelity",
    "MeshReshapeStability", "KReorderStability", "IllConditionedSolve",
    "QuantizedOptimizer",
    "DEFAULT_VALIDATORS",
]
