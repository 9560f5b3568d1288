"""Ill-conditioned dot-product generator (Ogita, Rump & Oishi, SIAM J. Sci.
Comput. 2005, Algorithm 6.1), counterpart of ``repro.data.conditioned``: the
standard way to manufacture dot products with a prescribed condition number.
This is the data substrate for the SSH reproducibility experiment (paper
Fig. 2): SSH reduces to long dot products whose conditioning grows with
vector size. Numpy and ``fractions`` only; for one seed every output is
bit-equal to the reference's.
"""

from __future__ import annotations

import numpy as np


def gen_dot(n: int, cond: float, seed: int = 0):
    """Generate f32 vectors a, b (length n) with cond(a·b) ≈ ``cond``.

    Returns (a, b, exact) with ``exact`` the dot product evaluated with
    exact (Fraction) arithmetic, as float64.
    """
    assert n >= 6
    rng = np.random.default_rng(seed)
    half = n // 2
    b_exp = np.log2(cond) / 2.0
    # first half: exponents spread from 0 up to b_exp/... (ORO 6.1)
    e = np.rint(rng.uniform(0, b_exp, half)).astype(np.int64)
    e[0] = int(np.rint(b_exp)) + 1
    e[-1] = 0
    a = np.float32((rng.uniform(-1, 1, half)) * (2.0 ** e))
    x = np.float32((rng.uniform(-1, 1, half)) * (2.0 ** e))
    # second half (ORO 6.1 proper): steer the running exact sum down through
    # the e2 ladder — each step the sum is *set near* a fresh value of
    # magnitude 2^e2[i], not cancelled to rounding noise, so the final value
    # is O(1) and cond(a·b) = sum|a_i b_i| / |a·b| lands at the prescribed
    # cond instead of overshooting to ~1e46 (which made every cond argument
    # produce the same un-sweepable, beyond-f128 problem)
    e2 = np.rint(np.linspace(int(np.rint(b_exp)), 0, n - half)).astype(np.int64)
    a2 = np.zeros(n - half, np.float32)
    x2 = np.zeros(n - half, np.float32)
    from fractions import Fraction
    acc = _exact_dot(a, x)
    for i in range(n - half):
        a2[i] = np.float32(rng.uniform(-1, 1) * 2.0 ** e2[i])
        if a2[i] == 0:
            a2[i] = np.float32(2.0 ** e2[i])
        target = Fraction(np.float64(rng.uniform(-1, 1) * 2.0 ** e2[i]))
        x2[i] = np.float32(float((target - acc) / Fraction(np.float64(a2[i]))))
        acc += Fraction(np.float64(a2[i])) * Fraction(np.float64(x2[i]))
    a_full = np.concatenate([a, a2])
    x_full = np.concatenate([x, x2])
    perm = rng.permutation(n)
    a_full, x_full = a_full[perm], x_full[perm]
    exact = float(_exact_dot(a_full, x_full))
    return a_full, x_full, exact


def _exact_dot(a, b):
    from fractions import Fraction
    s = Fraction(0)
    for x, y in zip(np.asarray(a, np.float64).tolist(),
                    np.asarray(b, np.float64).tolist()):
        s += Fraction(x) * Fraction(y)
    return s


def gen_linear_system(n: int, cond: float, seed: int = 0):
    """Companion to ``gen_dot``: an (n, n) system with prescribed condition.

    A is built by scaled SVD — seeded orthogonal U, V (QR of gaussians) around
    log-spaced singular values 1 .. 1/cond — and x is the smallest singular
    direction plus a little noise, so the row dots of A·x cancel by ~cond and
    probing them exercises exactly the regime an ill-conditioned *solve*
    lives in. Everything is rounded to f32 first (the data a deployed kernel
    would actually see; past cond ~ 1e7 the achievable cancellation saturates
    at the f32 grid) and the reference is then computed on those f32 values
    in exact (Fraction) arithmetic.

    Returns ``(A, x, exact)`` with ``A`` (n, n) f32, ``x`` (n,) f32 and
    ``exact`` (n,) float64 — the exact-arithmetic value of each row dot
    A[i]·x. ``residual_exact`` turns this into an exact residual reference
    against any candidate solution/readout.
    """
    assert n >= 2
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0.0, -np.log10(cond), n)
    A = np.float32(u @ np.diag(s) @ v.T)
    # noise scaled to the smallest singular value: the perturbation's image
    # through A stays at the ~1/cond level of s_min·u_min, so the row dots
    # keep their full ~log2(cond) bits of cancellation
    x = np.float32(v[:, -1] + (0.1 / cond) * rng.standard_normal(n))
    exact = np.array([float(_exact_dot(A[i], x)) for i in range(n)],
                     np.float64)
    return A, x, exact


def residual_exact(A, x, b):
    """Exact-arithmetic residual A·x - b of f32 data, as float64 — the
    reference a tailored-kernel residual computation is scored against."""
    from fractions import Fraction
    A = np.asarray(A)
    out = np.empty(A.shape[0], np.float64)
    for i in range(A.shape[0]):
        out[i] = float(_exact_dot(A[i], x) - Fraction(np.float64(b[i])))
    return out


def ssh_surrogate_batch(n: int, cond: float, m: int = 8, seed: int = 0):
    """A batch of m ill-conditioned dot products (the SSH stencil rows)."""
    out = [gen_dot(n, cond, seed + i) for i in range(m)]
    a = np.stack([o[0] for o in out])
    b = np.stack([o[1] for o in out])
    exact = np.array([o[2] for o in out], np.float64)
    return a, b, exact
