"""Training loop substrate (counterpart of ``repro.train.loop``, one device):
the chunked next-token loss, a train step with microbatched gradient
accumulation (optionally on the paper's fixed-point grid, so the sum does
not depend on the order of the microbatches), and a fault-tolerant
``Trainer``.

The step runs under the policy given to ``make_train_step``: every forward
site, every ``@bwd.dA``/``@bwd.dB`` site and every checkpointed recompute
resolves under it (the dispatch layer keeps the forward's policy for the
backward, which torch runs on its own thread for CUDA tensors). The step
updates the parameters in place and reads nothing back to the host: loss,
accuracy and gradient norm stay device tensors.

Waiting for later slices: ``sharded_value_and_grad`` and
``make_mesh_train_step`` (multi-device, ROADMAP queue 1 item 12), and the
``repro.obs`` step-time histogram, restart counter and spans (item 11);
``Trainer`` keeps its step times in ``monitor`` and its restarts in
``restarts`` until then.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core import dispatch
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import NumericsPolicy, use_policy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from .optimizer import Optimizer


def make_loss_fn(cfg, *, z_loss: float = 0.0, remat: str = "block",
                 loss_chunk: int = 512):
    """Next-token cross-entropy over ``{"tokens", "targets", "loss_mask"}``.

    The loss runs over sequence chunks, each checkpointed, so the (B, S,
    vocab) logits are never held for the backward: each chunk's logits are
    recomputed from the hidden states during backward (the LM head runs
    twice forward). Returns ``loss_fn(params, batch) -> (loss, {"loss",
    "accuracy"})``."""

    def chunk_step(h, head, t, m):
        logits = L.dense(h.to(torch.float32), head.to(torch.float32), "lm_head")
        logits = logits[..., :cfg.vocab_size]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, t[..., None], dim=-1)[..., 0]
        return (torch.sum((lse - gold) * m), torch.sum(torch.square(lse) * m),
                torch.sum((logits.argmax(-1) == t) * m))

    def loss_fn(params, batch):
        hidden = T.forward(params, cfg, batch, remat=remat, return_hidden=True)
        targets = batch["targets"].to(torch.int64)
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
        S = hidden.shape[1]
        ck = min(loss_chunk, S)
        zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
        nll_sum, zsum, correct = zero, zero, zero
        for c0 in range(0, S, ck):
            sl = slice(c0, c0 + ck)
            nll, z, corr = dispatch.checkpoint(chunk_step, hidden[:, sl], params.lm_head,
                                               targets[:, sl], mask[:, sl])
            nll_sum, zsum, correct = nll_sum + nll, zsum + z, correct + corr
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss = nll_sum / denom
        if z_loss:
            loss = loss + z_loss * zsum / denom
        return loss, {"loss": loss, "accuracy": correct / denom}

    return loss_fn


def make_train_step(cfg, opt: Optimizer, *, remat: str = "block",
                    microbatches: int = 1,
                    fdp_grad_spec: Optional[AccumulatorSpec] = None,
                    z_loss: float = 0.0,
                    numerics_policy: Optional[NumericsPolicy] = None):
    """Returns ``step((params, opt_state), batch) -> ((params, opt_state),
    metrics)``; ``params`` (a ``Transformer``) and ``opt_state`` are updated
    in place and returned.

    ``microbatches > 1``: gradients accumulated over microbatches.
    ``fdp_grad_spec``: accumulate them on the spec's fixed-point grid in
    int32, so any order of the microbatches gives the same bits.
    ``numerics_policy``: the policy of the whole step, forward and backward
    (else the caller's)."""
    loss_fn = make_loss_fn(cfg, z_loss=z_loss, remat=remat)

    def single(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return dict(zip(names, grads)), {k: v.detach() for k, v in metrics.items()}

    def accumulate(params, batch):
        def split(x):
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {x.shape[0]} does not split into "
                                 f"{microbatches} microbatches")
            return x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])

        mb = {k: split(v) for k, v in batch.items()}
        scale = 2.0 ** (fdp_grad_spec.lsb if fdp_grad_spec else 0)
        acc, ms = None, []
        for i in range(microbatches):
            grads, metrics = single(params, {k: v[i] for k, v in mb.items()})
            if fdp_grad_spec is not None:
                grads = {k: torch.round(g.to(torch.float32) / scale).to(torch.int32)
                         for k, g in grads.items()}
            else:
                grads = {k: g.to(torch.float32) for k, g in grads.items()}
            acc = grads if acc is None else {k: acc[k] + g for k, g in grads.items()}
            ms.append(metrics)
        dtypes = {k: p.dtype for k, p in params.named_parameters()}
        if fdp_grad_spec is not None:
            grads = {k: (a.to(torch.float32) * scale / microbatches).to(dtypes[k])
                     for k, a in acc.items()}
        else:
            grads = {k: (a / microbatches).to(dtypes[k]) for k, a in acc.items()}
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return grads, metrics

    def step(carry, batch):
        params, opt_state = carry
        ctx = (use_policy(numerics_policy) if numerics_policy is not None
               else contextlib.nullcontext())
        with ctx:
            grads, metrics = (accumulate if microbatches > 1 else single)(params, batch)
        if opt.apply is not None:
            opt_state = opt.apply(grads, opt_state, params)
        else:
            updates, opt_state = opt.update(grads, opt_state, params)
            with torch.no_grad():
                for name, p in params.named_parameters():
                    p.add_(updates[name])
        metrics = dict(metrics)
        metrics["grad_norm"] = opt_state["grad_norm"]
        return (params, opt_state), metrics

    return step


# ---------------------------------------------------------------------------
# Fault-tolerant driver
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time outlier detector; records (step, seconds, ewma) of each
    step slower than ``factor`` times the running average."""

    factor: float = 3.0
    alpha: float = 0.1
    ewma: float = 0.0
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        if self.ewma == 0.0:
            self.ewma = dt
            return False
        is_straggler = dt > self.factor * self.ewma
        if is_straggler:
            self.events.append((step, dt, self.ewma))
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class InjectedFailure(RuntimeError):
    pass


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return torch.from_numpy(tree.copy()).to(dev)


class Trainer:
    """Checkpointed, restartable training driver.

    Every step runs under a catch-and-restore guard: a ``RuntimeError`` (a
    CUDA error and ``torch.OutOfMemoryError`` are ones) or an injected
    failure rolls back to the last checkpoint and replays. Data is a pure
    function of the step, so the replay is exact. ``restarts`` counts the
    restores of the last ``run``."""

    def __init__(self, cfg, opt: Optimizer, data: Callable[[int], dict], step_fn,
                 checkpoint_dir: str, save_every: int = 50, keep: int = 3,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 device=None, seed: int = 0):
        from repro_torch.checkpoint.store import CheckpointStore
        from repro_torch.device import resolve_device
        self.device = resolve_device(device)
        self.cfg, self.opt, self.data, self.step_fn = cfg, opt, data, step_fn
        self.store = CheckpointStore(checkpoint_dir, keep=keep)
        self.save_every = save_every
        self.monitor = StragglerMonitor()
        self.failure_injector = failure_injector
        self.seed = seed
        self.metrics_log: list = []
        self.restarts = 0

    def init_or_restore(self):
        """``(step, (params, opt_state))`` from the newest valid checkpoint,
        else a fresh init from ``seed``."""
        from repro_torch.models.transformer import Transformer, init
        restored = self.store.load_latest()
        if restored is None:
            params = init(self.cfg, self.seed, device=self.device)
            return 0, (params, self.opt.init(params))
        step, tree = restored
        params = Transformer(self.cfg, gen=None, dtype=getattr(torch, self.cfg.param_dtype),
                             device=self.device)
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(torch.from_numpy(tree["params"][name]))
        return step, (params, _to_device(tree["opt_state"], self.device))

    def run(self, n_steps: int, max_restarts: int = 3):
        step, carry = self.init_or_restore()
        self.restarts = 0
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.failure_injector is not None:
                    self.failure_injector(step)
                carry, metrics = self.step_fn(carry, self.data(step))
                self.metrics_log.append({k: float(v) for k, v in metrics.items()}
                                        | {"step": step})
                self.monitor.record(step, time.perf_counter() - t0)
                step += 1
                if step % self.save_every == 0 or step == n_steps:
                    self.store.save(step, {"params": dict(carry[0].named_parameters()),
                                           "opt_state": carry[1]})
            except RuntimeError:           # a device fault, or InjectedFailure
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                carry = None               # free the failed state before restoring
                step, carry = self.init_or_restore()
        return carry
