"""Numerical-quality metrics used throughout the paper's evaluation
(counterpart of ``repro.core.metrics``).

``correct_bits`` is the paper's Fig. 2 y-axis: the number of leading mantissa
bits of a result that agree with the infinitely-precise reference. Every
metric takes tensors (on any device), numpy arrays or Python numbers and is
computed in float64 on the host: metrics are an offline reduction.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch


def _host(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def correct_bits(value, reference, cap: float = 53.0):
    """-log2(|v - ref| / |ref|), clipped to [0, cap]; cap when exact."""
    v = _host(value, np.float64)
    r = _host(reference, np.float64)
    err = np.abs(v - r)
    denom = np.maximum(np.abs(r), np.finfo(np.float64).tiny)
    rel = err / denom
    with np.errstate(divide="ignore"):
        bits = -np.log2(rel)
    bits = np.where(rel == 0.0, cap, bits)
    return np.clip(bits, 0.0, cap)


def exact_dot_fraction(a, b) -> Fraction:
    """Infinitely-precise dot product via Python Fractions (host oracle)."""
    s = Fraction(0)
    for x, y in zip(_host(a, np.float64).tolist(), _host(b, np.float64).tolist()):
        s += Fraction(x) * Fraction(y)
    return s


def fraction_to_float(f: Fraction) -> float:
    return float(f)


def reproducibility_deviation(fn, a, b, n_orders: int = 8, seed: int = 0):
    """Max absolute deviation of fn(a, b) across random input permutations,
    the paper's reproducibility probe (0.0 for the FDP by construction). The
    permutations come from ``numpy.random.default_rng(seed)``, as in the
    reference; ``fn`` gets tensors on ``a``'s device (the CPU for numpy
    inputs)."""
    rng = np.random.default_rng(seed)
    dev = a.device if isinstance(a, torch.Tensor) else torch.device("cpu")
    a, b = _host(a), _host(b)
    vals = []
    for i in range(n_orders):
        perm = rng.permutation(a.shape[0]) if i else np.arange(a.shape[0])
        out = fn(torch.as_tensor(a[perm], device=dev), torch.as_tensor(b[perm], device=dev))
        vals.append(float(_host(out)))
    vals = np.asarray(vals, dtype=np.float64)
    return float(np.max(np.abs(vals - vals[0]))), vals


def top1_agreement(logits, ref_logits) -> float:
    """Fig. 3 proxy metric: fraction of samples whose argmax matches the
    exact-accumulator reference."""
    return float(np.mean(_host(logits).argmax(-1) == _host(ref_logits).argmax(-1)))
