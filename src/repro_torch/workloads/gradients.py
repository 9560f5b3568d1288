"""Loss-gradient validator: what do the backward datapaths cost, end to end?
(counterpart of ``repro.workloads.gradients``)

A real training-loss gradient under the candidate policy, scored against
the *91-bit-bwd reference*: the identical policy with every backward site
(explicit assignments and the ``*@bwd`` fallback alike) forced onto the
paper's <30,30,-30> exact accumulator. Forward configs are common to both
runs, so forward error is common-mode and the score isolates what the
searched backward truncations cost the gradients. That is also why the
attribution is ``{"*@bwd": score}``: this validator can only be fixed by
widening backward sites.

The gradients stay on the validator's device and are scored there in
float64, with the reference's formulas (``correct_bits``, ``np.median``'s
mean of the two middle values, the cosine): at full width a copy to host
float64 would be two 6 GB trees a run. Leaves are grouped and named as the
reference's parameter tree is: one leaf per parameter kind, the layers
stacked, named by ``keystr`` (``"['layers']['attn']['wk']"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import GemmConfig, _parse_pattern, use_policy
from repro_torch.core.formats import FP32
from repro_torch.device import resolve_device
from repro_torch.numerics.search import _check_full_fp32, _default_fdp_mode

from .base import ValidationReport, Validator, WorkloadContext, register

GRAD_CAP_BITS = 24.0


def bwd91_reference_policy(policy, fdp_mode: str = "simulate"):
    """The policy with its entire backward namespace forced to the paper's
    91-bit exact FDP in ``fdp_mode`` (the dense kernel, ``pallas``, or its
    plain version, ``simulate``: the same bits), and *only* the backward
    namespace, so forward error stays common-mode between candidate and
    reference: bwd-phase patterns are rewritten in place (exact keys
    included: a ``*@bwd`` append would lose to them on specificity),
    phase-``*`` patterns keep their config for the forward half and get a
    higher-specificity ``name@bwd`` pin for the backward half, and a
    ``*@bwd`` catch-all covers the rest."""
    ref_cfg = GemmConfig(FP32, AccumulatorSpec.paper_91bit(), fdp_mode)
    overrides = []
    for pat, cfg in getattr(policy, "overrides", ()):
        name, phase, _op = _parse_pattern(pat)
        if phase == "bwd":
            overrides.append((pat, ref_cfg))
        else:
            overrides.append((pat, cfg))
            if phase == "*":
                # name@bwd (specificity name+phase) outranks name@* for bwd
                # lookups while leaving the pattern's fwd half untouched
                overrides.append((f"{name}@bwd", ref_cfg))
    overrides.append(("*@bwd", ref_cfg))
    return dataclasses.replace(policy, overrides=tuple(overrides),
                               name=f"{policy.name}+bwd91")


def correct_bits_t(value: torch.Tensor, reference: torch.Tensor,
                   cap: float) -> torch.Tensor:
    """``metrics.correct_bits`` on the tensors' device, in float64."""
    v, r = value.to(torch.float64), reference.to(torch.float64)
    rel = (v - r).abs() / r.abs().clamp(min=np.finfo(np.float64).tiny)
    bits = torch.where(rel == 0.0, cap, -torch.log2(rel))
    return bits.clamp(0.0, cap)


def median_t(x: torch.Tensor) -> float:
    """``np.median`` of a 1-D tensor: the middle value, or the mean of the
    two middle values of an even count (``torch.median`` returns the lower
    one; ``torch.quantile`` refuses more than 2^24 elements)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    mid = s[n // 2 - 1:n // 2 + 1] if n % 2 == 0 else s[n // 2:n // 2 + 1]
    return float(mid.mean())


def named_leaves(params, grads) -> list:
    """``[(keystr, flat tensor)]`` in the reference tree's order: one leaf
    per parameter kind, the per-layer tensors stacked over the layer axis
    (as ``models.convert.params_to_numpy`` stacks them)."""
    per_path: dict = {}
    for (name, _), g in zip(params.named_parameters(), grads):
        parts = name.split(".")
        if parts[0] == "layers":
            per_path.setdefault(("layers", *parts[2:]), []).append((int(parts[1]), g))
        else:
            per_path[tuple(parts)] = [(0, g)]
    out = []
    for path in sorted(per_path):
        ts = [g for _, g in sorted(per_path[path], key=lambda ig: ig[0])]
        flat = torch.stack(ts).reshape(-1) if path[0] == "layers" else ts[0].reshape(-1)
        out.append(("".join(f"[{p!r}]" for p in path), flat.detach()))
    return out


@register
class LossGradient(Validator):
    """Correct bits (plus cosine similarity) of the loss gradients under the
    policy vs the 91-bit-bwd reference.

    The score is the *worst parameter tensor's* median correct bits, not the
    global median: a training step is only as good as its worst gradient.
    The per-leaf breakdown ships in ``details["worst_leaves"]``."""

    name = "grad"
    phases = ("bwd",)

    def __init__(self, cfg, params, grad_batch, *, threshold: float = 10.0,
                 device=None, fdp_mode: Optional[str] = None):
        self.cfg = cfg
        self.params = params
        self.grad_batch = grad_batch
        self.threshold = float(threshold)
        self.device = resolve_device(device)
        self.fdp_mode = fdp_mode or _default_fdp_mode(self.device)
        # single-slot reference-gradient cache: the 91-bit-bwd reference
        # depends only on the policy's forward configuration (its backward
        # namespace is pinned), so the search's @bwd-only upgrade iterations
        # reuse one reference. One slot, not a dict: only consecutive
        # iterations ever share a key, and a dict would pin a param-sized
        # gradient copy per forward upgrade for zero reuse.
        self._ref_key = None
        self._ref_val = None

    @classmethod
    def from_context(cls, ctx: WorkloadContext) -> "LossGradient":
        ctx.require_model(cls.name)
        if ctx.grad_batch is None:
            raise ValueError("workload 'grad' needs ctx.grad_batch "
                             "(a batch with targets/loss_mask)")
        return cls(ctx.cfg, ctx.params, ctx.grad_batch,
                   threshold=ctx.budget_bits, device=ctx.device)

    def _grads(self, policy):
        from repro_torch.train.loop import make_loss_fn

        loss_fn = make_loss_fn(self.cfg, remat="none")
        leaves = [p for _, p in self.params.named_parameters()]
        # the policy is installed around the backward too: CUDA autograd runs
        # it on its own thread, where the dispatch layer re-enters the
        # forward's policy
        with use_policy(policy):
            loss, _aux = loss_fn(self.params, self.grad_batch)
            grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), named_leaves(self.params, grads)

    def run(self, policy) -> ValidationReport:
        _check_full_fp32(self.device)
        # the reference is fully determined by the policy's non-bwd surface,
        # so bwd-only policy changes (what the search's grad-driven upgrades
        # produce) hit the cache
        key = (policy.default.tag(),
               tuple((pat, cfg.tag()) for pat, cfg in
                     getattr(policy, "overrides", ())
                     if _parse_pattern(pat)[1] != "bwd"))
        if key != self._ref_key:
            # value first, key last: a _grads failure must not register the
            # new key over the previous policy's cached reference
            self._ref_val = self._grads(
                bwd91_reference_policy(policy, self.fdp_mode))
            self._ref_key = key
        loss_ref, ref = self._ref_val
        loss_got, got = self._grads(policy)
        per_leaf, all_bits = {}, []
        dot = gg = rr = 0.0
        for (path, g), (_, r) in zip(got, ref):
            bits = correct_bits_t(g, r, GRAD_CAP_BITS)
            per_leaf[path] = median_t(bits)
            all_bits.append(bits)
            g64, r64 = g.to(torch.float64), r.to(torch.float64)
            dot += float(torch.dot(g64, r64))
            gg += float(torch.dot(g64, g64))
            rr += float(torch.dot(r64, r64))
        median_bits = median_t(torch.cat(all_bits))
        del all_bits
        worst = sorted(per_leaf, key=per_leaf.get)[:4]
        score = per_leaf[worst[0]]
        denom = float(np.sqrt(gg) * np.sqrt(rr))
        cosine = dot / denom if denom else 0.0
        return ValidationReport(
            workload=self.name, score=score, threshold=self.threshold,
            site_attribution={"*@bwd": score},
            details={"cosine": cosine, "median_bits": median_bits,
                     "worst_leaves": {w: per_leaf[w] for w in worst},
                     "loss": loss_got, "loss_ref": loss_ref,
                     "n_leaves": len(per_leaf)})
