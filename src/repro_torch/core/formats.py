"""Computer-format front end of the FDP datapath (PyTorch).

Counterpart of ``repro.core.formats``: IEEE-754, bfloat16 and posit inputs are
decoded to a (sign, integer-significand, exponent) triple before their
products enter the fixed-point accumulator.

``decode(x) -> Decoded(sign, mant, exp)`` with value ``(-1)^sign * mant * 2^exp``
where ``mant`` is in ``[0, 2^precision)`` (zero for ±0, NaN, Inf and NaR) and
the triple is exact for every finite input including subnormals.

Bit patterns are handled in int64 with explicit 32-bit masks: torch's ``>>``
on ``uint32`` is not implemented on the CPU, and int64 holds every unsigned
32-bit value, so each ``uint32`` step of the reference becomes an int64 step
followed by ``& 0xFFFFFFFF`` where it could wrap.
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Decoded:
    """Exact (sign, mantissa, exponent) decomposition: (-1)^s * m * 2^e.
    All integer fields are int64 tensors."""

    sign: torch.Tensor      # 0 or 1
    mant: torch.Tensor      # 0 <= m < 2^precision (0 iff value == 0 or special)
    exp: torch.Tensor       # exponent of the *integer* mantissa
    is_nan: torch.Tensor    # bool
    is_inf: torch.Tensor    # bool

    def map(self, fn) -> "Decoded":
        """Apply ``fn`` to every field (the pytree ``tree.map`` of the
        reference, for slicing and broadcasting)."""
        return Decoded(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of a 32-bit value (branch-free binary search)."""
    x = x.to(torch.int64) & _M32
    c = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        y = x >> shift
        move = y != 0
        c = c + torch.where(move, shift, 0)
        x = torch.where(move, y, x)
    return torch.where(x == 0, 32, 31 - c)


def _ilog2(m: torch.Tensor) -> torch.Tensor:
    """floor(log2(m)) for positive values."""
    return 31 - _clz32(m)


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """An IEEE-754-style binary interchange format (<= 32 bits wide)."""

    name: str
    exp_bits: int
    mant_bits: int          # explicit fraction bits (no implicit bit)
    torch_dtype: torch.dtype

    @property
    def precision(self) -> int:       # significand incl. implicit bit
        return self.mant_bits + 1

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def emax(self) -> int:
        return self.bias

    @property
    def emin(self) -> int:           # min normal exponent
        return 1 - self.bias

    def decode(self, x: torch.Tensor) -> Decoded:
        """Exact (sign, mant, exp). Input is upcast to f32 (exact for every
        format narrower than f32), then decoded with integer bit ops."""
        bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & _M32
        sign = (bits >> 31) & 1
        biased = (bits >> 23) & 0xFF
        frac = bits & 0x7FFFFF
        is_sub = biased == 0
        is_special = biased == 0xFF
        mant = torch.where(is_sub, frac, frac | (1 << 23))
        exp = torch.where(is_sub, -126 - 23, biased - 127 - 23)
        mant = torch.where(is_special, 0, mant)
        is_nan = is_special & (frac != 0)
        is_inf = is_special & (frac == 0)
        return Decoded(sign, mant, exp, is_nan, is_inf)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round onto this format's grid (RNE) and return it as f32."""
        return x.to(torch.float32).to(self.torch_dtype).to(torch.float32)


FP32 = FloatFormat("ieee_fp32", 8, 23, torch.float32)
BF16 = FloatFormat("bfloat16", 8, 7, torch.bfloat16)
FP16 = FloatFormat("ieee_fp16", 5, 10, torch.float16)


# ---------------------------------------------------------------------------
# Posit<n, es>, stored as int32 bit patterns in the low ``nbits``.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PositFormat:
    """Posit<nbits, es> (posit standard 2022). NaR decodes to is_nan;
    ``from_float`` saturates at ±maxpos (posits have no infinities)."""

    name: str
    nbits: int
    es: int

    @property
    def precision(self) -> int:
        # max significand bits incl. implicit bit (minimal regime of 2 bits)
        return max(1, self.nbits - 3 - self.es) + 1

    def decode(self, p: torch.Tensor) -> Decoded:
        n, es = self.nbits, self.es
        mask = (1 << n) - 1
        u = p.to(torch.int64) & mask
        sign = (u >> (n - 1)) & 1
        is_zero = u == 0
        is_nar = u == (1 << (n - 1))
        body = torch.where(sign == 1, (-u) & mask, u)
        body = body & ((1 << (n - 1)) - 1)                    # low n-1 bits
        # regime: run of identical bits starting at bit n-2
        aligned = (body << (33 - n)) & _M32                   # bit n-2 -> bit 31
        first = (aligned >> 31) & 1
        probe = torch.where(first == 1, (~aligned) & _M32, aligned)
        run = torch.clamp(_clz32(probe), max=n - 1)
        k = torch.where(first == 1, run - 1, -run)
        rem = torch.clamp(n - 1 - run - 1, min=0)             # bits for es+frac
        one = torch.ones_like(rem)
        tail = body & ((one << rem) - 1)
        e_take = torch.clamp(rem, max=es)
        e_bits = tail >> (rem - e_take)
        e_val = e_bits << (es - e_take)                       # missing low e bits = 0
        f_bits = rem - e_take
        frac = tail & ((one << f_bits) - 1)
        mant = (one << f_bits) | frac                         # 1.frac as integer
        scale = k * (1 << es) + e_val                         # exponent of leading 1
        exp = scale - f_bits
        mant = torch.where(is_zero | is_nar, 0, mant)
        return Decoded(sign, mant, exp, is_nar, torch.zeros_like(is_nar))

    def to_float(self, p: torch.Tensor) -> torch.Tensor:
        d = self.decode(p)
        v = _ldexp_f32(d.mant, d.exp)
        v = torch.where(d.sign == 1, -v, v)
        return torch.where(d.is_nan, torch.tensor(float("nan"), device=v.device), v)

    def from_float(self, x: torch.Tensor) -> torch.Tensor:
        """RNE-encode f32 -> nearest posit pattern (saturating, no underflow
        to 0), as int32."""
        n, es = self.nbits, self.es
        d = FP32.decode(x)
        is_zero = d.mant == 0
        # normalize integer mantissa to [2^23, 2^24)
        up = torch.clamp(23 - _ilog2(torch.clamp(d.mant, min=1)), min=0)
        m = d.mant << up
        scale = d.exp - up + 23                               # exp of leading 1
        k = torch.div(scale, 1 << es, rounding_mode="floor")
        e = scale - k * (1 << es)                             # in [0, 2^es)
        run = torch.where(k >= 0, k + 1, -k)
        run = torch.clamp(run, 1, n - 1)
        reg_len = torch.clamp(run + 1, max=n - 1)             # incl. terminator
        rem = n - 1 - reg_len                                 # bits for e+frac
        e_take = torch.clamp(rem, max=es)
        f_bits = torch.clamp(rem - es, min=0)
        # combined (es+23)-bit stream of exponent+fraction bits
        frac23 = m & ((1 << 23) - 1)
        stream = (e << 23) | frac23
        t = (es + 23) - (e_take + f_bits)                     # dropped low bits
        # t < 0: the posit has more fraction bits than the f32 source, so
        # zero-pad on the right instead of shifting by a negative amount.
        tpos = torch.clamp(t, min=0)
        tneg = torch.clamp(-t, min=0)
        taken = torch.where(t >= 0, stream >> tpos, (stream << tneg) & _M32)
        one = torch.ones_like(t)
        tm1 = torch.clamp(t - 1, min=0)
        guard = torch.where(t >= 1, (stream >> tm1) & 1, 0)
        sticky = torch.where(t >= 1, (stream & ((one << tm1) - 1)) != 0, False)
        # regime field bits (within low n-1): run ones+0 (k>=0) / run zeros+1 (k<0)
        ones = (one << run) - 1
        reg_bits = torch.where(k >= 0, (ones << (reg_len - run)) & _M32,
                               torch.where(reg_len > run, 1, 0))
        body = ((reg_bits << rem) & _M32) | taken
        rnd = (guard == 1) & (sticky | ((body & 1) == 1))
        body = (body + rnd.to(torch.int64)) & _M32
        maxpos = (1 << (n - 1)) - 1
        body = torch.clamp(body, 1, maxpos)                   # saturate, no flush to 0
        mask = (1 << n) - 1
        patt = torch.where(d.sign == 1, (-body) & mask, body)
        patt = torch.where(is_zero, 0, patt)
        patt = torch.where(d.is_nan | d.is_inf, 1 << (n - 1), patt)
        # int32 carrier of the low n bits (two's-complement view for n = 32)
        return torch.where(patt >= 1 << 31, patt - (1 << 32), patt).to(torch.int32)


def _ldexp_f32(mant: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """mant * 2^exp (mant < 2^53) rounded once to f32. The power of two is
    assembled from f64 bits, so the f64 product is exact and the cast is the
    only rounding; the CUDA kernel builds its result the same way. Clamping
    exp to f64's normal range changes nothing: beyond it the f32 result is
    0 or inf either way."""
    e = torch.clamp(exp.to(torch.int64), -1022, 1023)
    pow2 = ((e + 1023) << 52).view(torch.float64)
    return (mant.to(torch.float64) * pow2).to(torch.float32)


POSIT16_1 = PositFormat("posit16_1", 16, 1)
POSIT32_2 = PositFormat("posit32_2", 32, 2)
POSIT8_0 = PositFormat("posit8_0", 8, 0)

FORMATS = {
    f.name: f for f in (FP32, BF16, FP16, POSIT16_1, POSIT32_2, POSIT8_0)
}


def get_format(name: str):
    return FORMATS[name]
