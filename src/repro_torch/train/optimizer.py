"""From-scratch optimizers (counterpart of ``repro.train.optimizer``): AdamW
with decoupled weight decay, global-norm clipping, a cosine schedule, and
Adam moments optionally held in block-scaled low-bit carriers
(``core.qformat``) between steps: dequantize, EMA-update, requantize.

A parameter tree here is a ``{name: tensor}`` dict (or a module, read
through ``named_parameters``). ``Optimizer.update`` is the reference's
functional form, ``(grads, state, params) -> (updates, state)``.
``Optimizer.apply`` is what the train step runs: it adds each leaf's update
to its parameter in place as soon as it is computed, a slice of the leaf at
a time, and drops that leaf's gradient, so no tree of updates is ever held
and the temporaries stay at a few slices however large the leaf (a 4.23 GB
expert weight of dbrx-132b). Both compute the same arithmetic, elementwise
in the reference's order.

``state_quant_from_policy`` reads the moment formats off a policy's aux
assignments (a precision plan's ``opt.m@state``/``opt.v@state`` sites).
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.core import qformat
from repro_torch.core.qformat import QuantConfig


# Elements of one leaf updated at a time by ``Optimizer.apply``: a power of
# two, so a whole number of quantization blocks of any format.
_APPLY_CHUNK = 1 << 24


class Optimizer(NamedTuple):
    init: Callable
    update: Callable                  # (grads, state, params) -> (updates, state)
    apply: Optional[Callable] = None  # (grads, state, params) -> state, in place


def _tree(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def cosine_schedule(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine decay to ``floor *
    base_lr`` at ``total``; f32, on the step tensor's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    leaves = list(_tree(tree).values())
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def clip_by_global_norm(tree, max_norm: float):
    tree = _tree(tree)
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: x * scale for k, x in tree.items()}, norm


def _quantize_moment(x: torch.Tensor, cfg: QuantConfig, *, sqrt_domain: bool = False):
    """``sqrt_domain``: nu is stored as sqrt(nu), rounded up on the grid, so
    the dequantized denominator never understates curvature (a nu rounded
    to zero under a non-zero mu gives an amax/eps update)."""
    if sqrt_domain:
        return qformat.block_quantize(torch.sqrt(torch.clamp(x.to(torch.float32), min=0.0)),
                                      cfg, rounding="up")
    return qformat.block_quantize(x, cfg)


def _dequantize_moment(carrier: dict, cfg: QuantConfig, shape, *,
                       sqrt_domain: bool = False) -> torch.Tensor:
    x = qformat.block_dequantize(carrier, cfg, shape)
    return x.square_() if sqrt_domain else x


def optimizer_state_bytes(state) -> int:
    """Resident bytes of the moment carriers (tensor bytes, measured)."""
    total = 0
    for moment in ("mu", "nu"):
        for leaf in state[moment].values():
            parts = leaf.values() if isinstance(leaf, dict) else (leaf,)
            total += sum(t.numel() * t.element_size() for t in parts)
    return total


def state_quant_from_policy(policy) -> Optional[dict]:
    """Map a ``NumericsPolicy``'s aux assignments onto ``adamw``'s
    ``state_quant`` argument (None when the policy holds both moments at
    fp32: no aux entries, or explicit fp32 ones)."""
    if policy is None or not getattr(policy, "aux", ()):
        return None
    out = {}
    for moment, site in (("mu", qformat.OPT_M_SITE), ("nu", qformat.OPT_V_SITE)):
        cfg = policy.aux_lookup(site.key)
        if cfg is not None and cfg.mode == "block":
            out[moment] = cfg
    return out or None


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0,
          state_quant: Optional[Mapping[str, QuantConfig]] = None) -> Optimizer:
    """``state_quant`` maps moment names ("mu", "nu") to block-scaled
    ``QuantConfig``s; listed moments persist as int8/int16 carriers. fp32-mode
    configs are treated as unlisted."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    squant = {k: v for k, v in (state_quant or {}).items() if v.mode == "block"}
    for k in squant:
        if k not in ("mu", "nu"):
            raise ValueError(f"state_quant key {k!r} (expected 'mu'/'nu')")

    def init(params):
        tree = _tree(params)
        dev = next(iter(tree.values())).device
        state = {"mu": {}, "nu": {}, "step": torch.zeros((), dtype=torch.int32, device=dev),
                 "grad_norm": torch.zeros((), dtype=torch.float32, device=dev)}
        for name, p in tree.items():
            for moment in ("mu", "nu"):
                z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                cfg = squant.get(moment)
                state[moment][name] = z if cfg is None else _quantize_moment(
                    z, cfg, sqrt_domain=moment == "nu")
        return state

    def moments_and_update(m, v, g, p, step_state):
        """This step's moments (updated in place in ``m`` and ``v``) and the
        parameter update, elementwise in the reference's order."""
        bc1, bc2, lr_t = step_state
        g = g.to(torch.float32)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        u = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
        if weight_decay:
            u.add_(weight_decay * p.to(torch.float32))
        return (-lr_t * u).to(p.dtype)

    def load(state, moment, name, lo, hi):
        """Elements [lo, hi) of a leaf's moment as f32 (a view of an f32
        moment; a copy dequantized from the block rows that hold them)."""
        leaf = state[moment][name]
        cfg = squant.get(moment)
        if cfg is None:
            return leaf.view(-1)[lo:hi]
        rows = slice(lo // cfg.block, -(-hi // cfg.block))
        return _dequantize_moment({"q": leaf["q"][rows], "exp": leaf["exp"][rows]}, cfg,
                                  (hi - lo,), sqrt_domain=moment == "nu")

    def store(state, moment, name, lo, x):
        """Requantize elements [lo, lo + len(x)) into the leaf's carrier (an
        f32 moment was updated where it lies). Requantizing after the update
        is computed from the full-precision moments rounds only the
        carried-over EMA tail."""
        cfg = squant.get(moment)
        if cfg is not None:
            c = _quantize_moment(x, cfg, sqrt_domain=moment == "nu")
            rows = slice(lo // cfg.block, lo // cfg.block + c["q"].shape[0])
            state[moment][name]["q"][rows] = c["q"]
            state[moment][name]["exp"][rows] = c["exp"]

    def prologue(grads, state):
        step = state["step"] + 1
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
        scale = None
        if clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        t = step.to(torch.float32)
        return step, gnorm, scale, (1 - b1 ** t, 1 - b2 ** t, lr_fn(step))

    def update(grads, state, params):
        grads, tree = _tree(grads), _tree(params)
        step, gnorm, scale, step_state = prologue(grads, state)
        new = {"mu": {}, "nu": {}, "step": step, "grad_norm": gnorm}
        for moment in ("mu", "nu"):
            for name, leaf in state[moment].items():
                new[moment][name] = ({k: t.clone() for k, t in leaf.items()}
                                     if isinstance(leaf, dict) else leaf.clone())
        updates = {}
        for name, p in tree.items():
            g = grads[name] if scale is None else grads[name] * scale
            n = p.numel()
            m, v = load(new, "mu", name, 0, n), load(new, "nu", name, 0, n)
            updates[name] = moments_and_update(m, v, g.reshape(-1), p.reshape(-1),
                                               step_state).reshape(p.shape)
            store(new, "mu", name, 0, m)
            store(new, "nu", name, 0, v)
        return updates, new

    @torch.no_grad()
    def apply(grads: dict, state, params):
        """The update added to each parameter in place, one leaf at a time
        and within a leaf ``_APPLY_CHUNK`` elements at a time (a whole
        number of quantization blocks, so the carriers are the same), so
        the temporaries stay small whatever the leaf; consumes ``grads``
        (each entry is dropped once used) and updates ``state`` in place."""
        tree = _tree(params)
        step, gnorm, scale, step_state = prologue(grads, state)
        for name, p in tree.items():
            g = grads.pop(name).reshape(-1)
            if scale is not None:
                g = g * scale
            flat = p.view(-1)
            for lo in range(0, flat.numel(), _APPLY_CHUNK):
                hi = min(flat.numel(), lo + _APPLY_CHUNK)
                m, v = load(state, "mu", name, lo, hi), load(state, "nu", name, lo, hi)
                u = moments_and_update(m, v, g[lo:hi], flat[lo:hi], step_state)
                store(state, "mu", name, lo, m)
                store(state, "nu", name, lo, v)
                flat[lo:hi].add_(u)
            del g
        state["step"], state["grad_norm"] = step, gnorm
        return state

    return Optimizer(init, update, apply)


def apply_updates(params, updates):
    """params + updates, leaf by leaf (a new tree)."""
    tree = _tree(params)
    return {k: p + updates[k] for k, p in tree.items()}
