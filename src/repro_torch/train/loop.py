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

The ``Trainer`` reports to ``repro_torch.obs``'s default registry and
recorder, as the reference's does: the ``repro_train_step_seconds``
histogram (every executed step, the replayed ones too), the
``repro_train_restarts_total`` counter (one a restore) and a
``train.step`` span a step. The reference's ``train.step_trace`` and
``train.mesh_step_trace`` spans bracket a jit trace, which an eager step
does not have.

Data parallelism over a ``launch.mesh.DeviceMesh``:
``sharded_value_and_grad`` averages each rank's gradients over mesh axes,
on the fixed-point grid as an exact int32 all-reduce when given a spec, and
``make_mesh_train_step`` runs the whole model on each rank's slice of the
global batch, so one step gives the same bits on every factorization of
the same ranks. ``make_train_step`` on a ``Distribution`` with a mesh (the
reference's GSPMD profiles, which place the parameters) waits for ROADMAP
queue 1, *Multi-device*, placement and entry points; the sharded forward
and its gradients run today (``models.transformer.forward(..., dist)``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from repro_torch.core import dispatch, qformat
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import NumericsPolicy, use_policy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import axes as M

from .optimizer import Optimizer


def make_loss_fn(cfg, *, z_loss: float = 0.0, remat: str = "block",
                 loss_chunk: int = 512):
    """Next-token cross-entropy over ``{"tokens", "targets", "loss_mask"}``
    plus the family's extras (vlm ``patches``, scored on the text positions
    only; encdec ``frames``).

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
        if cfg.family == "vlm":                 # text positions only
            hidden = hidden[:, cfg.n_patches:]
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


def _grads(loss_fn, params, batch):
    """``loss_fn``'s gradients by parameter name, in ``named_parameters``
    order, and its metrics, detached."""
    names, leaves = zip(*params.named_parameters())
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return dict(zip(names, grads)), {k: v.detach() for k, v in metrics.items()}


def _apply(opt: Optimizer, grads: dict, opt_state, params):
    """One optimizer update of ``params`` in place; the new state."""
    if opt.apply is not None:
        return opt.apply(grads, opt_state, params)
    updates, opt_state = opt.update(grads, opt_state, params)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.add_(updates[name])
    return opt_state


def make_train_step(cfg, opt: Optimizer, dist: L.Distribution = L.LOCAL, *,
                    remat: str = "block", microbatches: int = 1,
                    fdp_grad_spec: Optional[AccumulatorSpec] = None,
                    z_loss: float = 0.0,
                    numerics_policy: Optional[NumericsPolicy] = None):
    """Returns ``step((params, opt_state), batch) -> ((params, opt_state),
    metrics)``; ``params`` (a ``Transformer``) and ``opt_state`` are updated
    in place and returned.

    ``microbatches > 1``: gradients accumulated over microbatches.
    ``fdp_grad_spec``: accumulate them on the spec's fixed-point grid in
    int32, so any order of the microbatches gives the same bits.
    ``numerics_policy``: the policy of the whole step, forward and backward;
    else the one riding on ``dist``; else the caller's. ``dist`` must have
    no mesh (module docstring)."""
    if dist.mesh is not None:
        raise NotImplementedError(
            "make_train_step over a mesh (the GSPMD profiles) waits for ROADMAP "
            "queue 1, *Multi-device*, placement and entry points; data parallelism "
            "is make_mesh_train_step")
    if numerics_policy is None:
        numerics_policy = dist.numerics_policy
    loss_fn = make_loss_fn(cfg, z_loss=z_loss, remat=remat)

    def single(params, batch):
        return _grads(loss_fn, params, batch)

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
        opt_state = _apply(opt, grads, opt_state, params)
        metrics = dict(metrics)
        metrics["grad_norm"] = opt_state["grad_norm"]
        return (params, opt_state), metrics

    return step


# ---------------------------------------------------------------------------
# Mesh data parallelism with an exact gradient mean
# ---------------------------------------------------------------------------
def _coalesced_mean(grads: dict, axis_names, quantize, dequantize, dtype) -> dict:
    """``dequantize`` of the sum over ``axis_names`` of every ``quantize``d
    gradient, through one flat buffer of ``dtype``: one all-reduce a mesh
    axis for the whole tree, not one a leaf (through gloo on CUDA tensors
    each is a host round trip). Each float gradient is dropped once it is
    in the buffer."""
    names = list(grads)
    shapes = {k: (grads[k].shape, grads[k].dtype) for k in names}
    flat = torch.empty(sum(grads[k].numel() for k in names), dtype=dtype,
                       device=grads[names[0]].device)
    off = 0
    for k in names:
        size = grads[k].numel()
        flat[off:off + size] = quantize(grads.pop(k)).reshape(-1)
        off += size
    M.psum(flat, axis_names, inplace=True)
    out, off = {}, 0
    for k in names:
        shape, gdtype = shapes[k]
        size = math.prod(shape)
        out[k] = dequantize(flat[off:off + size]).reshape(shape).to(gdtype)
        off += size
    return out


def sharded_value_and_grad(loss_fn, axis_names, *,
                           fdp_grad_spec: Optional[AccumulatorSpec] = None,
                           grad_quant=None):
    """Data-parallel value and gradients under a bound mesh: local
    gradients, then their mean over ``axis_names`` (a name or a tuple).
    Returns ``fn(params, batch) -> ((loss, metrics), grads)``.

    With ``fdp_grad_spec`` each rank's gradient is rounded onto the 2^lsb
    grid and the mean is an int32 all-reduce with one dequantize over a
    constant n: the same bits for any order or mesh factorization of the
    same ranks. Else ``grad_quant`` (a block-mode ``qformat.QuantConfig``)
    sends the mean through ``collectives.quantized_psum`` (a few bits an
    element, the ``grad_psum@coll`` site); else a float sum over n (order-
    dependent). ``fdp_grad_spec`` takes precedence. Loss and metrics take a
    float mean either way: diagnostics, not part of the bit contract."""

    def fn(params, batch):
        grads, metrics = _grads(loss_fn, params, batch)
        n = M.axis_size(axis_names)
        if fdp_grad_spec is not None:
            scale = 2.0 ** fdp_grad_spec.lsb
            grads = _coalesced_mean(
                grads, axis_names,
                lambda g: torch.round(g.to(torch.float32) / scale).to(torch.int32),
                lambda s: s.to(torch.float32) * scale / n, torch.int32)
        elif grad_quant is not None and grad_quant.mode == "block":
            from repro_torch.parallel.collectives import quantized_psum
            grads = {k: quantized_psum(g, axis_names, grad_quant, mean=True)
                     for k, g in grads.items()}
        else:
            grads = _coalesced_mean(grads, axis_names, lambda g: g, lambda s: s / n,
                                    torch.float32)
        keys = list(metrics)
        mean = M.pmean(torch.stack([metrics[k].to(torch.float32) for k in keys]),
                       axis_names)
        metrics = dict(zip(keys, mean.unbind()))
        return (metrics["loss"], metrics), grads

    return fn


def _rank_slice(x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not split over {n} ranks")
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def make_mesh_train_step(cfg, opt: Optimizer, dist: L.Distribution, *,
                         remat: str = "none", z_loss: float = 0.0,
                         fdp_grad_spec: Optional[AccumulatorSpec] = None,
                         numerics_policy: Optional[NumericsPolicy] = None,
                         grad_quant=None):
    """Train step over the flattened mesh of ``dist`` (pure data
    parallelism): the global batch is split over all mesh axes jointly, so
    rank r takes slice r whatever the factorization; each rank runs the
    whole model on its slice under the policy, and gradients reduce through
    ``sharded_value_and_grad``. A rank's shapes depend only on the rank
    count, so its local compute is the same on 1x8, 2x4 and 8x1; with
    ``fdp_grad_spec`` the reduction is exact, and one step gives the same
    logits, loss gradients and updated parameters on every factorization.
    The update then runs identically on every rank.

    ``numerics_policy`` defaults to ``dist.numerics_policy``; ``grad_quant``
    to the policy's ``grad_psum@coll`` assignment (``fdp_grad_spec`` still
    wins). Returns ``step((params, opt_state), global_batch) -> ((params,
    opt_state), metrics)``; ``params`` are updated in place."""
    if numerics_policy is None:
        numerics_policy = dist.numerics_policy
    if grad_quant is None and numerics_policy is not None:
        grad_quant = numerics_policy.aux_lookup(qformat.GRAD_PSUM_SITE.key)
    mesh = dist.mesh
    axes = tuple(mesh.axis_names)
    vg = sharded_value_and_grad(make_loss_fn(cfg, z_loss=z_loss, remat=remat), axes,
                                fdp_grad_spec=fdp_grad_spec, grad_quant=grad_quant)

    def step(carry, batch):
        params, opt_state = carry
        local = {k: _rank_slice(v, mesh.size, mesh.rank) for k, v in batch.items()}
        ctx = (use_policy(numerics_policy) if numerics_policy is not None
               else contextlib.nullcontext())
        with M.use_mesh(mesh), ctx:
            (_loss, metrics), grads = vg(params, local)
        opt_state = _apply(opt, grads, opt_state, params)
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
    restores of the last ``run``; the registry's counter counts them all
    (module docstring)."""

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
        from repro_torch.obs.registry import default_registry
        self._m_step = default_registry().histogram(
            "repro_train_step_seconds", "Trainer per-step wall time")
        self._m_restarts = default_registry().counter(
            "repro_train_restarts_total", "fault-tolerant restore events")

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
        from repro_torch.obs.spans import span
        step, carry = self.init_or_restore()
        self.restarts = 0
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.failure_injector is not None:
                    self.failure_injector(step)
                batch = self.data(step)
                with span("train.step", step=step):
                    carry, metrics = self.step_fn(carry, batch)
                # the host reads the metrics: the step's device work is done
                self.metrics_log.append({k: float(v) for k, v in metrics.items()}
                                        | {"step": step})
                dt = time.perf_counter() - t0
                self.monitor.record(step, dt)
                self._m_step.observe(dt)
                step += 1
                if step % self.save_every == 0 or step == n_steps:
                    self.store.save(step, {"params": dict(carry[0].named_parameters()),
                                           "opt_state": carry[1]})
            except RuntimeError:           # a device fault, or InjectedFailure
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                self._m_restarts.inc()
                carry = None               # free the failed state before restoring
                step, carry = self.init_or_restore()
        return carry
