"""Inference-quality probe: logit fidelity vs the uniform 91-bit oracle
(counterpart of ``repro.workloads.inference``).

A real model forward under the candidate policy, scored in median correct
bits of the logits against the paper's uniform <30,30,-30> FDP policy, with
top-1 agreement (the paper's Fig. 3 proxy metric) reported alongside. Its
score is what plans record as ``validated_bits``. The 91-bit reference runs
through the dense kernel on a card (``FDP91_KERNEL``) and through the plain
version elsewhere (``FDP91``, the reference's): the same bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.dispatch import FDP91, use_policy
from repro_torch.core.metrics import correct_bits, top1_agreement
from repro_torch.device import resolve_device
from repro_torch.launch.serve import FDP91_KERNEL
from repro_torch.numerics.search import _check_full_fp32, _default_fdp_mode

from .base import ValidationReport, Validator, WorkloadContext, register

LOGIT_CAP_BITS = 24.0


def fdp91_policy(fdp_mode: str):
    """The uniform 91-bit FDP policy through the dense kernel (``pallas``)
    or its plain version (``simulate``)."""
    if fdp_mode not in ("simulate", "pallas"):
        raise ValueError(f"fdp_mode {fdp_mode!r} (expected simulate or pallas)")
    return FDP91 if fdp_mode == "simulate" else FDP91_KERNEL


@register
class LogitFidelity(Validator):

    name = "logits"
    phases = ("fwd",)

    def __init__(self, cfg, params, batch, *, threshold: float = 10.0,
                 device=None, fdp_mode: Optional[str] = None):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.threshold = float(threshold)
        self.device = resolve_device(device)
        self.ref_policy = fdp91_policy(fdp_mode or _default_fdp_mode(self.device))
        self._ref = None                      # FDP91 logits, computed once

    @classmethod
    def from_context(cls, ctx: WorkloadContext) -> "LogitFidelity":
        ctx.require_model(cls.name)
        return cls(ctx.cfg, ctx.params, ctx.batch, threshold=ctx.budget_bits,
                   device=ctx.device)

    def _forward(self, policy) -> np.ndarray:
        from repro_torch.models import forward

        with torch.no_grad(), use_policy(policy):
            out = forward(self.params, self.cfg, self.batch, remat="none")
        return out.cpu().numpy()

    def reference(self) -> np.ndarray:
        if self._ref is None:
            self._ref = self._forward(self.ref_policy)
        return self._ref

    def run(self, policy) -> ValidationReport:
        _check_full_fp32(self.device)
        ref = self.reference()
        got = self._forward(policy)
        bits = correct_bits(got, ref, cap=LOGIT_CAP_BITS)
        score = float(np.median(bits))
        return ValidationReport(
            workload=self.name, score=score, threshold=self.threshold,
            details={"top1_agreement": top1_agreement(got, ref),
                     "min_bits": float(np.min(bits)),
                     "n_logits": int(got.size)})
