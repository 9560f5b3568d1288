"""Reproducibility probe: bit-stability under K-reduction reordering
(counterpart of ``repro.workloads.reproducibility``).

The FDP's headline property (paper Fig. 2) is not accuracy but
*associativity*: a fixed-point accumulation gives the same bits for every
summation order, where native floating point drifts. This workload measures
exactly that, per deployed site: the same seeded GEMM is dispatched with
the K dimension permuted several ways (columns of A and rows of B permuted
together, so the mathematical product is unchanged), and the score is the
agreement between orderings in bits, capped at ``REPRO_CAP_BITS`` and
awarded in full when every ordering is bit-identical, which FDP backends
achieve by construction (the dense kernel included: its register is exact
whatever order its threads add in, unless it saturates).

The operands and permutations are the reference's numpy draws from
``default_rng(seed)``, moved to the validator's device; only a native
site's own summation order differs between the packages and devices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dispatch import gemm
from repro_torch.device import resolve_device
from repro_torch.numerics.search import _check_full_fp32

from .base import ValidationReport, Validator, WorkloadContext, probed_sites
from .base import register

REPRO_CAP_BITS = 53.0


@register
class KReorderStability(Validator):

    name = "repro"
    phases = ("fwd", "bwd")

    def __init__(self, *, m: int = 8, n: int = 8, k: int = 256,
                 n_orders: int = 4, seed: int = 0, threshold: float = 10.0,
                 device=None):
        rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
        perms = [np.arange(k)] + [rng.permutation(k)
                                  for _ in range(n_orders - 1)]
        self.pairs = [(torch.from_numpy(np.ascontiguousarray(a[:, p])).to(self.device),
                       torch.from_numpy(np.ascontiguousarray(b[p, :])).to(self.device))
                      for p in perms]
        self.threshold = float(threshold)

    @classmethod
    def from_context(cls, ctx: WorkloadContext) -> "KReorderStability":
        return cls(seed=ctx.seed, threshold=ctx.budget_bits, device=ctx.device)

    def _site_bits(self, site: str, policy) -> float:
        with torch.no_grad():
            outs = [gemm(a, b, site=site, policy=policy).cpu().numpy().astype(np.float64)
                    for a, b in self.pairs]
        ref = outs[0]
        dev = max(float(np.max(np.abs(o - ref))) for o in outs[1:])
        if dev == 0.0:
            return REPRO_CAP_BITS
        scale = float(np.max(np.abs(ref)))
        if scale == 0.0:
            return 0.0
        return float(np.clip(-np.log2(dev / scale), 0.0, REPRO_CAP_BITS))

    def run(self, policy) -> ValidationReport:
        _check_full_fp32(self.device)
        sites = probed_sites(policy) or ["workload_probe"]
        attribution = {s: self._site_bits(s, policy) for s in sites}
        weakest = min(attribution, key=attribution.get)
        return ValidationReport(
            workload=self.name, score=attribution[weakest],
            threshold=self.threshold, site_attribution=dict(attribution),
            details={"weakest_site": weakest,
                     "n_orders": len(self.pairs),
                     "bit_identical_sites":
                         sum(v >= REPRO_CAP_BITS
                             for v in attribution.values()),
                     "n_sites_probed": len(sites)})
