"""Compensated (float-float) reductions for the f32 path.

On the f32 path plain f32 dot products and norms carry O(n*eps) ~ 1e-4 relative error at the solver's
vector lengths, which caps the achievable operating point near eps=1e-5.
These routines recover ~f64-quality reductions using only f32 arithmetic:

* products are split exactly with Dekker's algorithm (TwoProd) — each
  ``x_i*y_i`` becomes an exact hi+lo pair;
* the summation is a binary-tree reduction in float-float (double-single)
  arithmetic — every level is one vectorized TwoSum, so the whole dot is
  ~log2(n) fused elementwise passes, negligible next to the O(n^2) matvec.

Error ~ O(eps^2 * n) ~ 1e-12 relative at n = 10^4: the reductions stop
being the accuracy bottleneck; the f32 *storage* of the iterate (eps ~
6e-8) becomes the floor, which the optional f64 refinement sweep
(interface/api.py ``refine``) then removes.

No reference counterpart (the reference is f64 throughout); this is the
f32 path's answer to its reliance on f64 BLAS.

These transforms rely on IEEE-exact add/sub/mul.  XLA does not apply
value-changing float rewrites by default, and the unit tests would catch a
regression (test_linalg.py::test_cdot_*).
"""

from __future__ import annotations

import jax.numpy as jnp


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (branch-free, 6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Dekker split into hi/lo halves of the mantissa (exact)."""
    # f32: 24-bit mantissa -> split constant 2^12 + 1; f64: 2^27 + 1.
    const = 4097.0 if a.dtype == jnp.float32 else 134217729.0
    c = const * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProd: p + err == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _ff_tree_sum_ff(hi, lo):
    """Sum a vector of float-float (hi, lo) pairs by binary-tree reduction,
    carrying the low parts; returns a normalized scalar (hi, lo) pair."""
    n = hi.shape[0]
    # pad to a power of two with exact zeros
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad = jnp.zeros(p - n, hi.dtype)
        hi = jnp.concatenate([hi, pad])
        lo = jnp.concatenate([lo, pad])
    while p > 1:
        h = p // 2
        s, e = _two_sum(hi[:h], hi[h:])
        lo = lo[:h] + lo[h:] + e
        hi = s
        p = h
    return _two_sum(hi[0], lo[0])


def cdot_ff(x, y):
    """Compensated dot product as a float-float (hi, lo) scalar pair —
    use when the caller must difference two near-equal dots (the HSDE gap
    residual |c'x + b'y|) without losing the low-order half."""
    p, e = _two_prod(x, y)
    return _ff_tree_sum_ff(p, e)


def cdot(x, y):
    """Compensated dot product: ~f64-accurate in pure f32 arithmetic,
    rounded to one f32 on return."""
    hi, lo = cdot_ff(x, y)
    return hi + lo


def cnorm(x):
    """Compensated 2-norm via the compensated sum of exact squares."""
    return jnp.sqrt(cdot(x, x))


def ff_add(a, b):
    """Add two float-float scalar pairs (normalized result)."""
    s, e = _two_sum(a[0], b[0])
    e = e + a[1] + b[1]
    return _two_sum(s, e)
