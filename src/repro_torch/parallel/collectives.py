"""Distributed numerics: the paper's fixed-point accumulation applied to
cross-rank collectives (counterpart of ``repro.parallel.collectives``).

A float all-reduce depends on its order: other topologies, or another
factorization of the same ranks, give other bits. ``reproducible_psum``
quantizes onto the ⟨ovf,msb,lsb⟩ grid and reduces in int32, where addition
is associative, so the result is the same for any order, topology or rank
count. ``fdp_psum`` reduces FDP accumulator registers themselves, so a
K-sharded FDP GEMM lands on the unsharded bits. With a coarse grid and
error feedback the grid doubles as gradient compression
(``CompressedGradReducer``); ``quantized_psum`` agrees a shared exponent a
block across ranks and sends a few bits an element.

Axis names (a name or a tuple of names) resolve against the mesh bound by
``repro_torch.parallel.axes.use_mesh``, the reference's ``shard_map`` axes.
Trees are dicts of tensors, or a module's ``named_parameters``.

Under ``validate_overflow()`` a quantized payload that would saturate its
grid width is detected rather than clipped. The check reads one flag back
to the host a call, and only under validation; in a collective the flag is
first all-reduced (max) over the collective's axes, so every rank of it
raises together, instead of the others waiting in the next collective. The
events count on ``repro_overflow_events_total{site,source="collective"}``,
the family the envelope monitor uses, once a saturating call in each rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.core import accumulator as acc
from repro_torch.core import qformat
from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.qformat import QuantConfig
from repro_torch.parallel.axes import axis_size, pmax, psum
from repro_torch.obs.registry import default_registry as _obs_registry

_VALIDATE_OVERFLOW: Optional[str] = None     # None | "raise" | "warn"

_OVERFLOW_EVENTS = _obs_registry().counter(
    "repro_overflow_events_total",
    "overflow/saturation events (accumulator wrap risk, non-finite "
    "outputs, quantized-collective spillover)", ("site", "source"))
_WARNED_SITES: set = set()


@contextlib.contextmanager
def validate_overflow(enabled: bool = True, *, mode: str = "raise"):
    """Validation mode: a quantized collective payload that would saturate
    its grid width is detected instead of silently clipped (clipping breaks
    the "same bits as one device" contract). ``mode="raise"`` raises
    ``OverflowError`` naming the site; ``mode="warn"`` counts the event and
    warns once a site (``RuntimeWarning``), and the run goes on."""
    if mode not in ("raise", "warn"):
        raise ValueError(f"validate_overflow mode {mode!r} "
                         "(expected 'raise' or 'warn')")
    global _VALIDATE_OVERFLOW
    prev = _VALIDATE_OVERFLOW
    _VALIDATE_OVERFLOW = mode if enabled else None
    try:
        yield
    finally:
        _VALIDATE_OVERFLOW = prev


def _on_saturation(site: str, mode: str, saturated: bool) -> None:
    if not saturated:
        return
    _OVERFLOW_EVENTS.inc(site=site, source="collective")
    msg = (f"[{site}] quantized collective payload saturates the grid "
           "width — the clipped reduction would not match single-device "
           "bits; widen the spec (ovf/msb) or rescale the payload")
    if mode == "warn":
        if site not in _WARNED_SITES:
            _WARNED_SITES.add(site)
            warnings.warn(msg, RuntimeWarning)
        return
    raise OverflowError(msg)


def _check_overflow(y: torch.Tensor, lim: float, site: str = "collective",
                    axes=None) -> None:
    """Under ``validate_overflow()``: flag any |y| past the signed range,
    attributed to ``site``; with ``axes``, a saturation on any rank along
    them (module docstring)."""
    mode = _VALIDATE_OVERFLOW
    if mode is None:
        return
    saturated = (y.abs() > lim).any().to(torch.int32)
    if axes is not None:
        saturated = pmax(saturated, axes)
    _on_saturation(site, mode, bool(saturated))


def _grid_quantize(x: torch.Tensor, lsb: int, width: int, generator=None,
                   site: str = "grid_quantize", axes=None) -> torch.Tensor:
    """Round to nearest (half to even) onto the 2^lsb grid, clip to signed
    ``width`` bits, int32. With a ``torch.Generator``, round stochastically
    (floor of y plus a uniform draw)."""
    y = x.to(torch.float32) / 2.0 ** lsb
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       device=y.device))
    else:
        y = torch.round(y)
    lim = 2.0 ** (width - 1) - 1
    _check_overflow(y, lim, site, axes)
    return torch.clamp(y, -lim, lim).to(torch.int32)


def _grid_dequantize(q: torch.Tensor, lsb: int, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * 2.0 ** lsb).to(dtype)


def _named(tree) -> dict:
    return dict(tree.named_parameters()) if isinstance(tree, torch.nn.Module) else tree


def quantize_tree(tree, spec: AccumulatorSpec, site: str = "quantize_tree") -> dict:
    return {k: _grid_quantize(x.detach(), spec.lsb, spec.width, site=site)
            for k, x in _named(tree).items()}


def dequantize_tree(tree: dict, spec: AccumulatorSpec, like=None) -> dict:
    if like is None:
        return {k: _grid_dequantize(q, spec.lsb) for k, q in tree.items()}
    like = _named(like)
    return {k: _grid_dequantize(q, spec.lsb, like[k].dtype) for k, q in tree.items()}


def reproducible_psum(x: torch.Tensor, axis_name, spec: AccumulatorSpec,
                      mean: bool = False) -> torch.Tensor:
    """Order-invariant psum: quantize, int32 psum, dequantize. The int32
    payload carries ``spec.width`` bits of information an element."""
    q = _grid_quantize(x, spec.lsb, spec.width, site="reproducible_psum@coll",
                       axes=axis_name)
    out = _grid_dequantize(psum(q, axis_name), spec.lsb, x.dtype)
    if mean:
        out = out / axis_size(axis_name)
    return out


def fdp_psum(limbs: torch.Tensor, axis_name, spec: AccumulatorSpec) -> torch.Tensor:
    """All-reduce of FDP accumulator registers in exact integer limb space.

    ``limbs`` is a carry-normalized partial-K register (trailing dim
    ``spec.num_limbs``), e.g. ``core.fdp.fdp_gemm_limbs`` of a local
    K-shard. Limb addition is exact, associative and commutative, so the
    int32 psum and one ``carry_normalize`` give the bits of accumulating
    everything on one device, for any order or mesh factorization.
    Headroom: digits 0..L-2 are in [0, 2^16) and the signed top limb carries
    the rest, so up to SAFE_CHUNK (2^13) ranks sum without digit overflow;
    the top limb's int32 wrap is congruent to the register's own wrap."""
    if limbs.shape[-1] != spec.num_limbs:
        raise AssertionError(f"limb register has {limbs.shape[-1]} limbs, spec wants "
                             f"{spec.num_limbs}")
    return acc.carry_normalize(spec, psum(limbs.to(torch.int32), axis_name))


def quantized_psum(x: torch.Tensor, axis_name, cfg: QuantConfig, *,
                   mean: bool = False, residual: Optional[torch.Tensor] = None,
                   site: str = qformat.GRAD_PSUM_SITE.key):
    """Block-scaled low-bit all-reduce (the ``grad_psum@coll`` site).

    The ranks first agree on each block's exponent (a max of the local block
    amax: exact and order-free), then each sends a ``cfg.bits``-wide integer
    payload on that block's grid and the sum runs in int32. ``residual``
    turns on error feedback: what rounding and clipping dropped this call is
    returned, to be added back next call. The grid is sized from ``x``
    alone, not ``x + residual``, so a residual that spills past it clips,
    which ``validate_overflow()`` makes loud. Returns ``out``, or ``(out,
    new_residual)`` with a residual. An fp32-mode cfg is a plain float psum.
    """
    if cfg.mode == "fp32":
        out = psum(x.to(torch.float32), axis_name)
        if mean:
            out = out / axis_size(axis_name)
        out = out.to(x.dtype)
        if residual is None:
            return out
        return out, torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    blocks = qformat._to_blocks(x, cfg.block)
    amax = pmax(blocks.abs().amax(dim=1), axis_name)
    _, scale = qformat.block_scale(amax, cfg.bits)
    payload = blocks
    if residual is not None:
        payload = payload + qformat._to_blocks(residual, cfg.block)
    y = torch.round(payload / scale[:, None])
    lim = 2.0 ** (cfg.bits - 1) - 1
    _check_overflow(y, lim, site, axis_name)
    q = torch.clamp(y, -lim, lim).to(torch.int32)
    s = psum(q, axis_name)

    def unblock(b):
        return b.reshape(-1)[: x.numel()].reshape(x.shape)

    out = unblock(s.to(torch.float32) * scale[:, None])
    if mean:
        out = out / axis_size(axis_name)
    out = out.to(x.dtype)
    if residual is None:
        return out
    sent = unblock(q.to(torch.float32) * scale[:, None])
    return out, (x.to(torch.float32) + residual) - sent


def _zeros_like_tree(params) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in _named(params).items()}


@dataclasses.dataclass
class QuantizedGradReducer:
    """Error-feedback gradient averaging over ``quantized_psum``, the
    block-scaled sibling of ``CompressedGradReducer`` (whose one global
    ⟨lsb,width⟩ grid cannot span a gradient tree at few bits)."""

    cfg: QuantConfig
    axis_name: object

    def init(self, params) -> dict:
        return _zeros_like_tree(params)

    def reduce(self, grads: dict, residual: dict):
        """Returns ``(mean_grads, new_residual)``."""
        out, new_r = {}, {}
        for k, g in grads.items():
            o, new_r[k] = quantized_psum(g, self.axis_name, self.cfg, mean=True,
                                         residual=residual[k])
            out[k] = o.to(g.dtype)
        return out, new_r


@dataclasses.dataclass
class CompressedGradReducer:
    """Error-feedback gradient compression on the fixed-point grid
    (1-bit-Adam-style residual carrying, with the paper's ⟨lsb,width⟩ knob
    instead of the sign)."""

    spec: AccumulatorSpec
    axis_name: object

    def init(self, params) -> dict:
        return _zeros_like_tree(params)

    def reduce(self, grads: dict, residual: dict):
        """Returns ``(reduced_grads, new_residual)``: the mean over the
        axis."""
        n = axis_size(self.axis_name)
        out, new_r = {}, {}
        for k, g in grads.items():
            g32 = g.to(torch.float32) + residual[k]
            q = _grid_quantize(g32, self.spec.lsb, self.spec.width,
                               site=qformat.GRAD_PSUM_SITE.key, axes=self.axis_name)
            new_r[k] = g32 - _grid_dequantize(q, self.spec.lsb)
            red = psum(q, self.axis_name)
            out[k] = (_grid_dequantize(red, self.spec.lsb) / n).to(g.dtype)
        return out, new_r
