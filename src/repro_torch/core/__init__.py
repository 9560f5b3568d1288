# The paper's primary contribution, in PyTorch:
# - formats:     IEEE-754 / bfloat16 / posit decode-encode front end
# - accumulator: the <ovf,msb,lsb> fixed-point (Kulisch) register, int32 limbs
# - fdp:         fused dot product / GEMM with exact accumulation
# - dispatch:    BLAS-style transparent numerics policy
from .accumulator import AccumulatorSpec, SAFE_CHUNK
from .formats import (BF16, FP16, FP32, POSIT8_0, POSIT16_1, POSIT32_2,
                      FloatFormat, PositFormat, get_format)
from .fdp import fdp_dot, fdp_gemm
from .dispatch import (FDP91, GemmPlan, GemmSite, plan_gemm, plan_cache_stats,
                       reset_sites_seen, sites_seen, widen_config)

__all__ = [
    "AccumulatorSpec", "SAFE_CHUNK", "FP32", "BF16", "FP16",
    "POSIT16_1", "POSIT32_2", "POSIT8_0", "FloatFormat", "PositFormat",
    "get_format", "fdp_dot", "fdp_gemm",
    "FDP91", "GemmPlan", "GemmSite", "plan_gemm", "plan_cache_stats",
    "reset_sites_seen", "sites_seen", "widen_config",
]
