"""Quantized-optimizer validator: what does low-bit training *state* cost?
(counterpart of ``repro.workloads.quant_opt``)

A short seeded training run where the Adam moments live in the candidate
block-scaled formats and every gradient goes through the collective
format's round trip, scored against the *fp32-state reference*: the
identical run with the same GEMM policy but full-precision state and exact
collectives. GEMM numerics are common-mode between the two runs, so the
loss-curve divergence isolates what the quantized state and compressed
collectives cost training.

The score is the *worst step's* correct bits of the loss curve, and the
attribution names the exact aux site keys the policy assigns, so the
search's upgrade loop widens the moment or collective format rather than
touching a GEMM.

The port's modules train in place, where the reference's steps are
functional: every curve starts from its own copy of the context's
parameters, which no run changes. Steps run eagerly, where the reference
compiles them.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from repro_torch.core import qformat
from repro_torch.core.dispatch import use_policy
from repro_torch.core.metrics import correct_bits
from repro_torch.device import resolve_device
from repro_torch.numerics.search import _check_full_fp32

from .base import ValidationReport, Validator, WorkloadContext, register

QUANT_OPT_CAP_BITS = 24.0
# Loss-curve fidelity floor: an 8-bit block-scaled moment keeps the probe
# curves well above this on the zoo models, a 4-bit one falls under it:
# the threshold separates "EMA tail rounding" from "the optimizer is
# following different gradients".
DEFAULT_THRESHOLD_BITS = 4.0


@register
class QuantizedOptimizer(Validator):
    """Worst-step correct bits of a short quantized-state training-loss curve
    vs the fp32-state reference under the same GEMM policy."""

    name = "quant_opt"
    phases = ("state", "collective")

    def __init__(self, cfg, params, grad_batch, *,
                 threshold: float = DEFAULT_THRESHOLD_BITS,
                 steps: int = 6, lr: float = 3e-3, device=None):
        self.cfg = cfg
        self.params = params
        self.grad_batch = grad_batch
        self.threshold = float(threshold)
        self.steps = int(steps)
        self.lr = float(lr)
        self.device = resolve_device(device)
        # single-slot reference cache: the fp32-state curve depends only on
        # the GEMM surface of the policy (aux is stripped from it), so the
        # search's aux-only upgrade iterations reuse one reference run.
        self._ref_key = None
        self._ref_val = None

    @classmethod
    def from_context(cls, ctx: WorkloadContext) -> "QuantizedOptimizer":
        ctx.require_model(cls.name)
        if ctx.grad_batch is None:
            raise ValueError("workload 'quant_opt' needs ctx.grad_batch "
                             "(a batch with targets/loss_mask)")
        return cls(ctx.cfg, ctx.params, ctx.grad_batch, device=ctx.device)

    def _curve(self, policy, state_quant, coll_cfg) -> list:
        from repro_torch.train.loop import make_loss_fn
        from repro_torch.train.optimizer import adamw, apply_updates

        loss_fn = make_loss_fn(self.cfg, remat="none")
        opt = adamw(self.lr, state_quant=state_quant)
        model = copy.deepcopy(self.params)          # this curve's own weights
        names, leaves = zip(*model.named_parameters())
        ostate = opt.init(model)
        losses = []
        for _ in range(self.steps):
            with use_policy(policy):
                loss, _aux = loss_fn(model, self.grad_batch)
                grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            if coll_cfg is not None:
                # single-device emulation of quantized_psum's round trip:
                # same block math, axis size 1
                grads = {k: qformat.quantize_roundtrip(g, coll_cfg)
                         for k, g in grads.items()}
            updates, ostate = opt.update(grads, ostate, model)
            new = apply_updates(model, updates)
            del grads, updates
            with torch.no_grad():
                for name, p in zip(names, leaves):
                    p.copy_(new[name])
            del new
            losses.append(float(loss.detach()))
        return losses

    def run(self, policy) -> ValidationReport:
        from repro_torch.train.optimizer import state_quant_from_policy

        _check_full_fp32(self.device)
        base = dataclasses.replace(policy, aux=(),
                                   name=f"{policy.name}+fp32state")
        key = (policy.default.tag(),
               tuple((pat, cfg.tag()) for pat, cfg in
                     getattr(policy, "overrides", ())))
        if key != self._ref_key:
            # value first, key last: a failed run must not register the new
            # key over the previous policy's cached reference
            self._ref_val = self._curve(base, None, None)
            self._ref_key = key
        ref = self._ref_val

        squant = state_quant_from_policy(policy)
        coll = policy.aux_lookup(qformat.GRAD_PSUM_SITE.key)
        if coll is not None and coll.mode != "block":
            coll = None
        got = self._curve(base, squant, coll)

        per_step = [float(correct_bits(g, r, cap=QUANT_OPT_CAP_BITS))
                    for g, r in zip(got, ref)]
        score = min(per_step)
        quant_keys = [k for k, cfg in getattr(policy, "aux", ())
                      if cfg.mode == "block"]
        attribution = ({k: score for k in quant_keys} if quant_keys
                       else {"*@state": score, "*@coll": score})
        return ValidationReport(
            workload=self.name, score=score, threshold=self.threshold,
            site_attribution=attribution,
            details={"per_step_bits": per_step,
                     "loss_curve": got, "loss_curve_ref": ref,
                     "steps": self.steps,
                     "state_formats": {k: cfg.tag() for k, cfg
                                       in getattr(policy, "aux", ())}})
