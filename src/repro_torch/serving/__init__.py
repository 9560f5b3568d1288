# repro_torch.serving — bucketed serving with workload-conditional routing
# (counterpart of repro.serving).
#
# The tier above ``launch.batching`` that turns the plan zoo into a service:
#
#   router    - PlanRouter: MANIFEST-recorded per-workload scores -> a
#               concrete plan per request (chat/solve/repro classes or an
#               explicit plan name; constraints reject with RoutingError)
#   engine    - BucketedEnginePool: sorted (slots x len) buckets, lazy
#               per-(plan, bucket, method) engines for score/generate/stream,
#               each one CUDA graph on the card, LRU eviction of idle
#               engines under a live-engine cap
#   frontend  - RoutedFrontend: request queue with max-live-batches
#               backpressure, KV-budget admission control (park, never
#               truncate), completion futures, token streaming callbacks
#
# ``python -m repro_torch.serving`` serves a mixed trace and prints
# per-class routing/latency stats.
from .engine import (METHODS, AdmissionError, Bucket, BucketedEnginePool,
                     GenerateEngine, ScoreEngine, parse_buckets)
from .frontend import Completion, RoutedFrontend, ServeRequest
from .router import (FDP_CAP_BITS, REPRO_CERT_BITS, WORKLOAD_CLASSES,
                     PlanRouter, RoutedPlan, RoutingError, derive_variants,
                     routed_plan_from_entry)

__all__ = [
    "METHODS", "AdmissionError", "Bucket", "BucketedEnginePool",
    "GenerateEngine", "ScoreEngine", "parse_buckets",
    "Completion", "RoutedFrontend", "ServeRequest",
    "FDP_CAP_BITS", "REPRO_CERT_BITS", "WORKLOAD_CLASSES",
    "PlanRouter", "RoutedPlan", "RoutingError", "derive_variants",
    "routed_plan_from_entry",
]
