"""Ill-conditioned solve workload: the paper's Fig. 2 SSH experiment as a
reusable validator (counterpart of ``repro.workloads.solve``).

SSH (and every ill-conditioned solve) reduces to long dot products whose
condition number grows with problem size; stock floating point loses all
correct bits while the exact FDP accumulator keeps them. This workload
manufactures that regime on demand (Ogita-Rump-Oishi dot products,
``data.conditioned.gen_dot``, and prescribed-condition linear systems,
``gen_linear_system``, at sweepable condition numbers), runs them through
the *deployed* per-site datapaths of the policy under test on the
validator's device, and scores each site in correct bits against the
exact-arithmetic oracle.

Caveats, by design:

  * a site whose accumulator was calibrated on model activations may *wrap*
    on solve operands (products up to ~sqrt(cond)); the resulting ~0-bit
    score is the real answer to "can this plan serve an ill-conditioned
    solve", which is why this workload is opt-in for the DNN plan zoo;
  * the linear-system rows cancel from O(1) operands down to O(1/cond)
    values, so resolving them to b relative bits needs absolute accumulator
    resolution ~lsb <= -(b + log2 cond): even the paper's 91-bit
    <30,30,-30> drops to ~14/~6/0 bits on the cond=1e4/1e6/1e8 systems;
  * scores are capped at 24 bits (f32 read-out).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dispatch import gemm
from repro_torch.core.metrics import correct_bits
from repro_torch.data.conditioned import gen_dot, gen_linear_system
from repro_torch.device import resolve_device
from repro_torch.numerics.search import _check_full_fp32

from .base import ValidationReport, Validator, WorkloadContext, probed_sites
from .base import register

SOLVE_CAP_BITS = 24.0


@register
class IllConditionedSolve(Validator):
    """Batched ORO dot products + one prescribed-condition linear system per
    condition number, dispatched through every explicitly-assigned site of
    the policy (falling back to one ``workload_probe`` site on bare
    policies). Score = worst site's worst condition number, in correct bits
    vs the exact oracle; per-site attribution carries each site's own score
    so the search upgrades the site that actually failed the solve."""

    name = "solve"
    phases = ("fwd", "bwd")

    def __init__(self, *, conds=(1e4, 1e6, 1e8), n: int = 64,
                 n_dots: int = 4, system_n: int = 24, seed: int = 0,
                 threshold: float = 10.0, device=None):
        self.conds = tuple(float(c) for c in conds)
        self.threshold = float(threshold)
        self.device = resolve_device(device)
        self._cases = []
        for ci, cond in enumerate(self.conds):
            dots = [gen_dot(n, cond, seed + 97 * ci + i)
                    for i in range(n_dots)]
            a = np.stack([d[0] for d in dots])                  # (m, n)
            b = np.stack([d[1] for d in dots]).T                # (n, m)
            exact = np.array([d[2] for d in dots], np.float64)
            self._cases.append(("dot", cond, a, b, exact))
            A, x, bx = gen_linear_system(system_n, cond,
                                         seed=seed + 31 * ci)
            self._cases.append(("system", cond, A, x[:, None], bx))
        self._operands = [tuple(torch.from_numpy(np.ascontiguousarray(t)).to(self.device)
                                for t in (a, b))
                          for _, _, a, b, _ in self._cases]

    @classmethod
    def from_context(cls, ctx: WorkloadContext) -> "IllConditionedSolve":
        return cls(seed=ctx.seed, threshold=ctx.budget_bits, device=ctx.device)

    def run(self, policy) -> ValidationReport:
        _check_full_fp32(self.device)
        sites = probed_sites(policy) or ["workload_probe"]
        attribution, weakest = {}, None
        for site in sites:
            worst = SOLVE_CAP_BITS
            by_cond = {}
            for (kind, cond, _, _, exact), (a, b) in zip(self._cases, self._operands):
                with torch.no_grad():
                    out = gemm(a, b, site=site, policy=policy).cpu().numpy()
                out = out.astype(np.float64)
                got = np.diagonal(out) if kind == "dot" else out[:, 0]
                bits = float(np.median(correct_bits(got, exact,
                                                    cap=SOLVE_CAP_BITS)))
                key = f"{kind}@cond={cond:.0e}"
                by_cond[key] = min(by_cond.get(key, SOLVE_CAP_BITS), bits)
                worst = min(worst, bits)
            attribution[site] = worst
            if weakest is None or worst < weakest[1]:
                weakest = (site, worst, by_cond)
        site, score, by_cond = weakest
        return ValidationReport(
            workload=self.name, score=score, threshold=self.threshold,
            site_attribution=attribution,
            details={"conds": list(self.conds), "weakest_site": site,
                     "weakest_site_bits": {k: float(v)
                                           for k, v in by_cond.items()},
                     "n_sites_probed": len(sites)})
