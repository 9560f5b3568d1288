"""The numerically-tailored fixed-point accumulator (Kulisch register), in
PyTorch. Counterpart of ``repro.core.accumulator``; limb tensors are
bit-equal to it.

Normative semantics:
  * value(limbs) = sum_l limbs[l] * 2^(lsb + 16*l)   (int32 limbs, signed)
  * products are quantized ONCE at entry: round-toward-zero at 2^lsb
    (``trunc``) or RNE,
  * additions are exact; carries are propagated lazily (<= SAFE_CHUNK
    products between normalizations),
  * the register wraps (or saturates) at W = ovf + msb - lsb + 1 bits.

The algebra runs in int64 and returns int32 limbs. Where the reference's
int32 arithmetic can wrap (the top limb, which keeps the full signed
remainder), ``_wrap32`` reproduces the wrap explicitly.
"""

from __future__ import annotations

import dataclasses
import math
import torch

from .formats import Decoded, _ilog2, _ldexp_f32

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
# Max products safely accumulated between carry normalizations: per product
# a limb receives < 2^17 in magnitude; 2^13 * 2^17 = 2^30 < 2^31.
SAFE_CHUNK = 1 << 13


@dataclasses.dataclass(frozen=True)
class AccumulatorSpec:
    """<ovf, msb, lsb> accumulator. Width W = ovf + msb - lsb + 1 bits.

    ``msb``: weight of the largest magnitude bit kept (2^msb).
    ``lsb``: weight of the smallest bit kept (2^lsb), lsb <= msb.
    ``ovf``: carry headroom bits on top of msb.
    """

    ovf: int
    msb: int
    lsb: int
    round_mode: str = "trunc"        # product-entry quantization: trunc | rne
    overflow_mode: str = "wrap"      # wrap | saturate

    def __post_init__(self):
        if self.lsb > self.msb:
            raise ValueError(f"lsb ({self.lsb}) > msb ({self.msb})")
        if self.round_mode not in ("trunc", "rne"):
            raise ValueError(self.round_mode)
        if self.overflow_mode not in ("wrap", "saturate"):
            raise ValueError(self.overflow_mode)

    @property
    def width(self) -> int:
        return self.ovf + self.msb - self.lsb + 1

    @property
    def num_limbs(self) -> int:
        return -(-self.width // LIMB_BITS)

    def describe(self) -> str:
        return (f"FDP<ovf:{self.ovf}, msb:{self.msb}, lsb:{self.lsb}> "
                f"({self.width}-bit, {self.num_limbs} limbs, {self.round_mode}/"
                f"{self.overflow_mode})")

    @classmethod
    def paper_91bit(cls) -> "AccumulatorSpec":
        """The paper's flagship 91-bit <ovf:30, msb:30, lsb:-30> instance."""
        return cls(ovf=30, msb=30, lsb=-30)

    @classmethod
    def for_exact(cls, fmt, max_terms: int) -> "AccumulatorSpec":
        """Size an accumulator so that accumulating ``max_terms`` products of
        ``fmt`` values is EXACT and overflow-free (FCCM'22 sizing rule)."""
        p = fmt.precision
        emax, emin = fmt.emax, getattr(fmt, "emin", -fmt.emax)
        msb = 2 * emax + 2                   # |a*b| < 2^(2emax+2)
        lsb = 2 * (emin - (p - 1))           # smallest product bit (subnormal^2)
        ovf = max(1, math.ceil(math.log2(max(max_terms, 2))))
        return cls(ovf=ovf, msb=msb, lsb=lsb)

    @classmethod
    def quire(cls, posit_fmt, max_terms: int = 1 << 20) -> "AccumulatorSpec":
        """The posit standard's quire for posit<n,es>: wide enough that any
        dot product of posits is exact, with carry headroom."""
        n, es = posit_fmt.nbits, posit_fmt.es
        max_scale = (n - 2) * (1 << es)      # exponent of maxpos
        msb = 2 * max_scale + 2
        lsb = -2 * max_scale - 2 * posit_fmt.precision
        ovf = max(1, math.ceil(math.log2(max(max_terms, 2))))
        return cls(ovf=ovf, msb=msb, lsb=lsb)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor to the int32 range."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# ---------------------------------------------------------------------------
# Product entry: quantize an exact product onto the grid, as limb contributions
# ---------------------------------------------------------------------------
def _product_digits(a: Decoded, b: Decoded) -> tuple:
    """Exact 48-bit significand product a.mant*b.mant as three base-2^16
    digits (d0, d1, d2). One int64 multiply; the reference's 12-bit digit
    split yields the same digits."""
    m = a.mant * b.mant
    return m & LIMB_MASK, (m >> 16) & LIMB_MASK, m >> 32


def _pieces(digits, r: torch.Tensor) -> list:
    """The four base-2^16 pieces of ``digits`` shifted left by r (0..15):
    digit k's low part lands on piece k, its high part on piece k+1. The
    two never overlap (the low part has r zero bits at the bottom, the high
    part is < 2^r), so every piece is < 2^16."""
    lo = [(d << r) & LIMB_MASK for d in digits]
    hi = [(d << r) >> LIMB_BITS for d in digits]
    return [lo[0], lo[1] + hi[0], lo[2] + hi[1], hi[2]]


def _entry(spec: AccumulatorSpec, a: Decoded, b: Decoded):
    """Shared product-entry math: (signed pieces, j0, signed RNE increment or
    None), all broadcast to the products' shape."""
    digits = _product_digits(a, b)
    q = a.exp + b.exp - spec.lsb                          # grid bit offset
    neg = (a.sign ^ b.sign) == 1
    j0 = torch.div(q, LIMB_BITS, rounding_mode="floor")   # limb of digit 0
    r = q - j0 * LIMB_BITS                                # 0..15 sub-shift
    # Pieces are placed as MAGNITUDES and the sign applied after: dropping
    # below-limb-0 pieces of the non-negative form is round-toward-zero.
    pieces = [torch.where(neg, -p, p) for p in _pieces(digits, r)]
    inc = None
    if spec.round_mode == "rne":
        inc = _rne_increment(digits, q)
        inc = torch.where(neg, -inc, inc)
    shape = torch.broadcast_shapes(*(p.shape for p in pieces), j0.shape)
    pieces = [p.expand(shape) for p in pieces]
    return pieces, j0.expand(shape), (None if inc is None else inc.expand(shape))


def product_limbs(spec: AccumulatorSpec, a: Decoded, b: Decoded) -> torch.Tensor:
    """Exact limb contributions of the products a*b (elementwise), quantized
    at 2^lsb per ``spec.round_mode``: int32 (*batch, num_limbs); each limb's
    magnitude is < 2^17. Pieces that land below limb 0 or above limb L-1
    are dropped."""
    L = spec.num_limbs
    pieces, j0, inc = _entry(spec, a, b)
    out = []
    for l in range(L):
        acc_l = torch.zeros_like(j0)
        for i, piece in enumerate(pieces):
            acc_l = acc_l + torch.where(j0 == l - i, piece, 0)
        if inc is not None and l == 0:
            acc_l = acc_l + inc
        out.append(acc_l)
    return torch.stack(out, dim=-1).to(torch.int32)


def product_limb_block_sum(spec: AccumulatorSpec, a: Decoded, b: Decoded,
                           axis: int = 0) -> torch.Tensor:
    """``product_limbs(spec, a, b).sum(axis)`` without materializing the
    (*batch, L) contribution tensor: every piece is scatter-added into its
    limb slot (int64 addition is exact and order-free, so the result is
    bit-identical to the materialized form). The caller owns the SAFE_CHUNK
    headroom budget for the reduced axis. Returns int32 (*rest, L)."""
    if axis != 0:
        raise ValueError("the fused block sum reduces the leading axis")
    L = spec.num_limbs
    pieces, j0, inc = _entry(spec, a, b)
    kc, rest = j0.shape[0], j0.shape[1:]
    R = math.prod(rest)
    # slots: limb j0+i+3 for j0+i in [-3, L-1] (pieces below limb 0 land on
    # the discarded slots 0..2), slot L+3 collects pieces above limb L-1.
    src = [p.reshape(kc, R) for p in pieces]
    idx = [torch.clamp(j0.reshape(kc, R) + (i + 3), 0, L + 3)
           for i in range(len(pieces))]
    if inc is not None:
        src.append(inc.reshape(kc, R))
        idx.append(torch.full_like(idx[0], 3))
    src = torch.stack(src, dim=-1).permute(1, 0, 2).reshape(R, -1)
    idx = torch.stack(idx, dim=-1).permute(1, 0, 2).reshape(R, -1)
    out = torch.zeros((R, L + 4), dtype=torch.int64, device=src.device)
    out.scatter_add_(1, idx, src)
    return out[:, 3:3 + L].reshape(*rest, L).to(torch.int32)


def _rne_increment(digits, q: torch.Tensor) -> torch.Tensor:
    """The +1 ulp RNE increment (0/1, magnitude) for products whose base-2^16
    ``digits`` sit at grid bit offset ``q``: guard = product bit at grid
    position -1, sticky = OR of the bits below it, lsb_bit = product bit at
    grid position 0. The increment lands on limb 0."""
    nd = len(digits)

    def product_bit(pb):
        k = torch.div(pb, LIMB_BITS, rounding_mode="floor")
        s = pb - k * LIMB_BITS
        val = torch.zeros_like(pb)
        for kk in range(nd):
            val = val + torch.where(k == kk, (digits[kk] >> s) & 1, 0)
        return torch.where((pb >= 0) & (pb < LIMB_BITS * nd), val, 0)

    def bits_below(pb):   # OR of product bits strictly below pb
        any_below = torch.zeros(pb.shape, dtype=torch.bool, device=pb.device)
        for kk in range(nd):
            nbits = torch.clamp(pb - kk * LIMB_BITS, 0, LIMB_BITS)
            mask = (torch.ones_like(nbits) << nbits) - 1
            any_below = any_below | ((digits[kk] & mask) != 0)
        return any_below

    pb_guard = -1 - q
    guard = product_bit(pb_guard)
    sticky = bits_below(pb_guard)
    lsb_bit = product_bit(-q)
    inc = (guard == 1) & (sticky | (lsb_bit == 1))
    return inc.to(torch.int64)


# ---------------------------------------------------------------------------
# Carry normalization, wrap/saturate, read-out
# ---------------------------------------------------------------------------
def carry_normalize(spec: AccumulatorSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Propagate carries so limbs 0..L-2 are in [0, 2^16); the top limb keeps
    the full signed remainder (int32, wrapping as the reference's does). The
    W-bit wrap/saturation is applied once, at read-out."""
    L = spec.num_limbs
    limbs = limbs.to(torch.int64)
    out = []
    carry = torch.zeros(limbs.shape[:-1], dtype=torch.int64, device=limbs.device)
    for l in range(L - 1):
        t = limbs[..., l] + carry
        carry = t >> LIMB_BITS                     # arithmetic shift = floor
        out.append(t & LIMB_MASK)
    out.append(_wrap32(limbs[..., L - 1] + carry))
    return torch.stack(out, dim=-1).to(torch.int32)


def finalize(spec: AccumulatorSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Apply the register's W-bit wrap or saturation to a carry-normalized
    state (read-out step)."""
    L = spec.num_limbs
    return _apply_overflow(spec, limbs, limbs[..., L - 1])


def _apply_overflow(spec: AccumulatorSpec, norm: torch.Tensor,
                    top: torch.Tensor) -> torch.Tensor:
    """Wrap or saturate the register at W bits (two's complement)."""
    L, W = spec.num_limbs, spec.width
    top_bits = W - LIMB_BITS * (L - 1)              # 1..16 significant top bits
    top = top.to(torch.int64)
    if spec.overflow_mode == "wrap":
        # sign-extend the top limb from top_bits
        half = 1 << (top_bits - 1)
        wrapped_top = ((top + half) & ((1 << top_bits) - 1)) - half
        return torch.cat([norm[..., :L - 1],
                          wrapped_top[..., None].to(norm.dtype)], dim=-1)
    lo, hi = -(1 << (top_bits - 1)), (1 << (top_bits - 1)) - 1
    over = (top > hi)[..., None]
    under = (top < lo)[..., None]
    sat_hi = torch.full_like(norm, LIMB_MASK)
    sat_hi[..., L - 1] = hi
    sat_lo = torch.zeros_like(norm)
    sat_lo[..., L - 1] = lo
    base = torch.cat([norm[..., :L - 1],
                      torch.clamp(top, lo, hi)[..., None].to(norm.dtype)], dim=-1)
    base = torch.where(over, sat_hi, base)
    return torch.where(under, sat_lo, base)


def merge_states(spec: AccumulatorSpec, states: torch.Tensor,
                 axis: int = 0) -> torch.Tensor:
    """Merge carry-normalized partial accumulator states into one normalized
    register. Integer limb addition is exact, associative and commutative,
    so the result is bit-identical for any partition and merge order. Up to
    SAFE_CHUNK normalized states may be merged in one call."""
    if states.shape[axis] > SAFE_CHUNK:
        raise ValueError(f"{states.shape[axis]} states exceed SAFE_CHUNK")
    return carry_normalize(spec, states.to(torch.int64).sum(dim=axis))


def to_float(spec: AccumulatorSpec, limbs: torch.Tensor,
             out_precision: int = 24) -> torch.Tensor:
    """Round the accumulator ONCE to a float (RNE at ``out_precision`` bits)
    and return f32. ``limbs`` must be carry-normalized."""
    L = spec.num_limbs
    limbs = finalize(spec, limbs).to(torch.int64)
    sign_neg = limbs[..., L - 1] < 0
    mag = _negate_where(limbs, sign_neg)
    any_nz = torch.any(mag != 0, dim=-1)
    top_idx = torch.zeros(mag.shape[:-1], dtype=torch.int64, device=mag.device)
    for l in range(L):
        top_idx = torch.where(mag[..., l] != 0, l, top_idx)
    top_val = torch.gather(mag, -1, top_idx[..., None])[..., 0]
    hb = _ilog2(torch.clamp(top_val, min=1)) + top_idx * LIMB_BITS  # highest bit
    # extract out_precision bits [hb-p+1 .. hb], guard at hb-p, sticky below
    p = out_precision
    take_from = hb - p + 1                                          # may be < 0
    mant = _extract_bits(mag, take_from, p)
    guard = _extract_bits(mag, take_from - 1, 1)
    sticky = _any_below(mag, take_from - 2)   # strictly below the guard bit
    rnd = (guard == 1) & (sticky | ((mant & 1) == 1))
    mant = mant + rnd.to(torch.int64)
    # mantissa overflow (2^p) -> exact power of two, bump exponent
    ovf = mant == (1 << p)
    mant = torch.where(ovf, 1 << (p - 1), mant)
    exp = take_from + spec.lsb + ovf.to(torch.int64)
    v = _ldexp_f32(mant, exp)
    v = torch.where(sign_neg, -v, v)
    return torch.where(any_nz, v, torch.zeros_like(v))


def to_float64(spec: AccumulatorSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Round the accumulator ONCE to float64 (53-bit RNE). The mantissa is
    assembled from a 24-bit and a 29-bit piece of the magnitude, as the
    reference builds it from two int32 pieces."""
    L = spec.num_limbs
    limbs = finalize(spec, limbs).to(torch.int64)
    sign_neg = limbs[..., L - 1] < 0
    mag = _negate_where(limbs, sign_neg)
    any_nz = torch.any(mag != 0, dim=-1)
    top_idx = torch.zeros(mag.shape[:-1], dtype=torch.int64, device=mag.device)
    for l in range(L):
        top_idx = torch.where(mag[..., l] != 0, l, top_idx)
    top_val = torch.gather(mag, -1, top_idx[..., None])[..., 0]
    hb = _ilog2(torch.clamp(top_val, min=1)) + top_idx * LIMB_BITS
    p, lo_bits = 53, 29
    take_from = hb - p + 1
    hi = _extract_bits(mag, take_from + lo_bits, p - lo_bits)       # 24 bits
    lo = _extract_bits(mag, take_from, lo_bits)                     # 29 bits
    guard = _extract_bits(mag, take_from - 1, 1)
    sticky = _any_below(mag, take_from - 2)
    rnd = (guard == 1) & (sticky | ((lo & 1) == 1))
    # hi * 2^29 + lo + rnd <= 2^53: exact in the integers and in f64
    mant = ((hi << lo_bits) + lo + rnd.to(torch.int64)).to(torch.float64)
    v = _ldexp_f64(mant, take_from + spec.lsb)
    v = torch.where(sign_neg, -v, v)
    return torch.where(any_nz, v, torch.zeros_like(v))


def _ldexp_f64(x: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """x * 2^exp in f64, rounded once: the power is split into two normal
    powers of two assembled from f64 bits, the first product exact."""
    e1 = torch.clamp(exp.to(torch.int64), -1022, 1023)
    e2 = torch.clamp(exp.to(torch.int64) - e1, -1022, 1023)
    pow2 = lambda e: ((e + 1023) << 52).view(torch.float64)
    return x * pow2(e1) * pow2(e2)


def _negate_where(limbs: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """Two's-complement negate across base-2^16 limbs where ``cond``. Input
    must be carry-normalized; output where cond: magnitude digits in
    [0, 2^16)."""
    L = limbs.shape[-1]
    out = []
    borrow = torch.zeros(limbs.shape[:-1], dtype=limbs.dtype, device=limbs.device)
    for l in range(L):
        t = -limbs[..., l] - borrow
        neg = (t < 0).to(limbs.dtype)
        t = t + neg * (1 << LIMB_BITS)
        borrow = neg
        out.append(t)
    negated = torch.stack(out, dim=-1)
    return torch.where(cond[..., None], negated, limbs)


def _extract_bits(mag: torch.Tensor, start: torch.Tensor, nbits: int) -> torch.Tensor:
    """Bits [start, start+nbits) of the magnitude register. start may be
    negative (those bits read as 0). nbits <= 32 (three limbs hold them)."""
    j = torch.div(start, LIMB_BITS, rounding_mode="floor")
    s = start - j * LIMB_BITS                     # 0..15
    part0 = _limb_at(mag, j) >> s
    part1 = _limb_at(mag, j + 1) << (LIMB_BITS - s)
    # part2 only matters when s > 32 - nbits; clamp the shift.
    sh2 = torch.clamp(2 * LIMB_BITS - s, 0, 31)
    part2 = torch.where(s > 2 * LIMB_BITS - nbits, _limb_at(mag, j + 2) << sh2, 0)
    res = part0 | part1 | part2
    return res & ((1 << nbits) - 1)


def _limb_at(mag: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    L = mag.shape[-1]
    out = torch.zeros(mag.shape[:-1], dtype=mag.dtype, device=mag.device)
    for l in range(L):
        out = out + torch.where(idx == l, mag[..., l], 0)
    return torch.where((idx >= 0) & (idx < L), out, 0)


def _any_below(mag: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
    """OR of the magnitude bits at positions <= ``below``."""
    L = mag.shape[-1]
    any_set = torch.zeros(mag.shape[:-1], dtype=torch.bool, device=mag.device)
    for l in range(L):
        nbits = torch.clamp(below + 1 - l * LIMB_BITS, 0, LIMB_BITS)
        mask = (torch.ones_like(nbits) << nbits) - 1
        any_set = any_set | ((mag[..., l] & mask) != 0)
    return any_set
