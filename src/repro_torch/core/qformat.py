"""Block-scaled low-bit storage formats for non-GEMM precision sites
(counterpart of ``repro.core.qformat``).

The accumulator of each GEMM is tailored per site; this module applies the
same site-identity discipline to the two dominant byte consumers of
training: optimizer state (bytes resident: fp32 Adam moments are ~2x
params) and gradient collectives (bytes moved).

Site identity: ``StateSite("opt.m").key == "opt.m@state"`` and
``CollectiveSite("grad_psum").key == "grad_psum@coll"``, disjoint from
``GemmSite`` keys by construction; ``site_kind`` classifies any key. The
sites are data here; their formats arrive as a policy's aux assignments
(``dispatch.NumericsPolicy.aux``), which ``numerics/plan.py`` fills from a
plan's state and collective sites.

Format: ``QuantConfig(bits, block)`` groups values into blocks of ``block``
elements; each block carries one power-of-two exponent sized to its max
magnitude, and elements are rounded onto that 2^lsb grid as signed
``bits``-wide integers, carried in int8/int16 tensors (the resident saving
is real), the exponent as int8. Power-of-two scales keep quantize ->
dequantize exact in f32, so carriers are bit-equal to the reference's.
``mode="fp32"`` is the identity format.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Exponent of an all-zero block (any value works, since the payload is all
# zeros, but it must be the same everywhere for the bit-equality contract).
ZERO_BLOCK_EXP = -126

# ---------------------------------------------------------------------------
# Site identity
# ---------------------------------------------------------------------------
STATE_SUFFIX = "@state"
COLL_SUFFIX = "@coll"


def site_kind(key: str) -> str:
    """Classify a site key: "state" / "collective" for the aux grammars, else
    "gemm" (kind says which parser is responsible, not that the key is
    well-formed)."""
    if key.endswith(STATE_SUFFIX):
        return "state"
    if key.endswith(COLL_SUFFIX):
        return "collective"
    return "gemm"


def _check_aux_name(name: str, who: str) -> None:
    if not name or "@" in name or "*" in name:
        raise ValueError(f"{who} name {name!r} must be non-empty and free of "
                         "'@'/'*' (dots are allowed: 'opt.m')")


@dataclasses.dataclass(frozen=True)
class StateSite:
    """Identity of one persistent-state tensor family (e.g. the Adam first
    moment across the whole parameter tree)."""

    name: str
    namespace: str = "opt"

    def __post_init__(self):
        _check_aux_name(self.name, "StateSite")

    @property
    def key(self) -> str:
        return f"{self.name}{STATE_SUFFIX}"


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """Identity of one cross-device reduction payload (e.g. the gradient
    all-reduce of the data-parallel train step)."""

    name: str
    namespace: str = "train"

    def __post_init__(self):
        _check_aux_name(self.name, "CollectiveSite")

    @property
    def key(self) -> str:
        return f"{self.name}{COLL_SUFFIX}"


OPT_M_SITE = StateSite("opt.m")
OPT_V_SITE = StateSite("opt.v")
GRAD_PSUM_SITE = CollectiveSite("grad_psum")


# ---------------------------------------------------------------------------
# Format
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """One block-scaled integer format (or the fp32 identity).
    ``error_feedback`` only matters for collective sites."""

    bits: int = 8
    block: int = 64
    mode: str = "block"             # "block" | "fp32"
    error_feedback: bool = False

    def __post_init__(self):
        if self.mode not in ("block", "fp32"):
            raise ValueError(f"QuantConfig mode {self.mode!r}")
        if self.mode == "block":
            if not 2 <= self.bits <= 16:
                raise ValueError(f"bits={self.bits} outside the int8/int16 "
                                 "emulation range [2, 16]")
            if self.block < 1 or self.block & (self.block - 1):
                raise ValueError(f"block={self.block} must be a power of two")

    def tag(self) -> str:
        if self.mode == "fp32":
            return "fp32"
        ef = "+ef" if self.error_feedback else ""
        return f"q{self.bits}b{self.block}{ef}"

    @property
    def bytes_per_element(self) -> float:
        """Modeled bytes per element (payload + one int8 exponent a block)."""
        if self.mode == "fp32":
            return 4.0
        return self.bits / 8.0 + 1.0 / self.block

    def storage_dtype(self) -> torch.dtype:
        return torch.int8 if self.bits <= 8 else torch.int16

    def widen(self) -> "QuantConfig":
        """The next point up the fidelity ladder: more payload bits, then
        fp32."""
        if self.mode == "fp32":
            return self
        if self.bits < 8:
            return dataclasses.replace(self, bits=8)
        if self.bits < 16:
            return dataclasses.replace(self, bits=16)
        return QuantConfig(mode="fp32", error_feedback=self.error_feedback)


FP32_STATE = QuantConfig(mode="fp32")


def parse_quant(text: str) -> QuantConfig:
    """CLI spelling: "fp32", or "BITSxBLOCK" ("8x64"), with an optional
    "+ef" error-feedback suffix ("4x32+ef")."""
    t = text.strip().lower()
    ef = t.endswith("+ef")
    if ef:
        t = t[:-len("+ef")]
    if t == "fp32":
        return QuantConfig(mode="fp32", error_feedback=ef)
    try:
        bits, block = t.split("x")
        return QuantConfig(bits=int(bits), block=int(block), error_feedback=ef)
    except (ValueError, TypeError):
        raise ValueError(
            f"bad quant format {text!r}: expected 'fp32' or 'BITSxBLOCK' "
            "like '8x64' (optional '+ef' suffix)") from None


def quant_bytes(n_elements: int, cfg: QuantConfig) -> float:
    """Modeled bytes for ``n_elements`` under ``cfg`` (whole blocks)."""
    if cfg.mode == "fp32":
        return 4.0 * n_elements
    n_blocks = -(-n_elements // cfg.block)
    return n_blocks * (cfg.block * cfg.bits / 8.0 + 1.0)


# ---------------------------------------------------------------------------
# Block quantization math
# ---------------------------------------------------------------------------
def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e in f32 for integer-valued e, exactly (subnormals included)."""
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e.to(torch.int32))


def block_exponent(amax: torch.Tensor) -> torch.Tensor:
    """int32 exponent e with 2^(e-1) <= amax < 2^e (frexp convention); zero
    blocks land on ZERO_BLOCK_EXP; clipped into int8 range."""
    _, e = torch.frexp(amax.to(torch.float32))
    e = torch.where(amax > 0, e.to(torch.int32), ZERO_BLOCK_EXP)
    return torch.clamp(e, -126, 127).to(torch.int32)


def _to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def block_scale(amax: torch.Tensor, bits: int):
    """Per-block exponent and power-of-two scale such that every magnitude up
    to ``amax`` fits ``bits`` signed integers without clipping: lsb = e -
    (bits-1), with the exponent bumped one octave when ``amax`` itself would
    land past the signed limit. Returns ``(exp, scale)``, ``scale =
    2^(exp - (bits - 1))``."""
    e = block_exponent(amax)
    scale = _pow2(e - (bits - 1))
    lim = 2.0 ** (bits - 1) - 1
    e = torch.clamp(e + (amax > lim * scale).to(torch.int32), -126, 127)
    return e, _pow2(e - (bits - 1))


def block_quantize(x: torch.Tensor, cfg: QuantConfig, *,
                   rounding: str = "nearest") -> dict:
    """-> {"q": int8/int16 (n_blocks, block), "exp": int8 (n_blocks,)}.

    ``rounding="nearest"`` rounds onto each block's 2^lsb grid (half to
    even, as ``jnp.round``); ``"up"`` rounds magnitudes away from zero, the
    safe direction for a quantity that sits in a denominator."""
    if cfg.mode != "block":
        raise ValueError("fp32 mode has no quantized carrier")
    blocks = _to_blocks(x, cfg.block)
    e, scale = block_scale(blocks.abs().amax(dim=1), cfg.bits)
    lim = 2.0 ** (cfg.bits - 1) - 1
    y = blocks / scale[:, None]
    if rounding == "up":
        y = torch.sign(y) * torch.ceil(y.abs())
    elif rounding == "nearest":
        y = torch.round(y)
    else:
        raise ValueError(f"rounding {rounding!r}")
    q = torch.clamp(y, -lim, lim)
    return {"q": q.to(cfg.storage_dtype()), "exp": e.to(torch.int8)}


def block_dequantize(carrier: dict, cfg: QuantConfig, shape,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``block_quantize`` back onto ``shape`` (drops padding).
    int * power-of-two is exact in f32, so dequantization adds no error."""
    scale = _pow2(carrier["exp"].to(torch.int32) - (cfg.bits - 1))
    flat = (carrier["q"].to(torch.float32) * scale[:, None]).reshape(-1)
    n = math.prod(shape) if shape else 1
    return flat[:n].reshape(tuple(shape)).to(dtype)


def quantize_roundtrip(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """x projected onto the format's representable grid (what a reader of
    the stored payload reconstructs). Identity for fp32 mode."""
    if cfg.mode == "fp32":
        return x.to(torch.float32)
    return block_dequantize(block_quantize(x, cfg), cfg, x.shape, x.dtype)
