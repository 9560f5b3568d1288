# The paper's primary contribution, in PyTorch:
# - formats:     IEEE-754 / bfloat16 / posit decode-encode front end
# - accumulator: the <ovf,msb,lsb> fixed-point (Kulisch) register, int32 limbs
# - fdp:         fused dot product / GEMM with exact accumulation
# - dispatch:    BLAS-style transparent numerics policy
# - energy, metrics, generator: the datapath model, the quality metrics and
#                the kernel generator (generate_gemm)
# - schedules:   the persisted zoo of autotuned GEMM plans
from .accumulator import AccumulatorSpec, SAFE_CHUNK
from .formats import (BF16, FP16, FP32, POSIT8_0, POSIT16_1, POSIT32_2,
                      FloatFormat, PositFormat, get_format)
from .fdp import dd_dot, fdp_dot, fdp_gemm, fma_dot
from .dispatch import (FDP91, GemmPlan, GemmSite, PlanCacheStats, plan_gemm,
                       plan_cache_stats, policy_from_plan, register_plan,
                       reset_sites_seen, sites_seen, widen_config)
from .generator import DatapathReport, GeneratedGemm, datapath_report, generate_gemm
from .schedules import ScheduleZoo, preload_schedules

__all__ = [
    "AccumulatorSpec", "SAFE_CHUNK", "FP32", "BF16", "FP16",
    "POSIT16_1", "POSIT32_2", "POSIT8_0", "FloatFormat", "PositFormat",
    "get_format", "fdp_dot", "fdp_gemm", "fma_dot", "dd_dot",
    "FDP91", "GemmPlan", "GemmSite", "PlanCacheStats", "plan_gemm",
    "plan_cache_stats", "policy_from_plan", "register_plan", "reset_sites_seen",
    "sites_seen", "widen_config",
    "DatapathReport", "GeneratedGemm", "datapath_report", "generate_gemm",
    "ScheduleZoo", "preload_schedules",
]
