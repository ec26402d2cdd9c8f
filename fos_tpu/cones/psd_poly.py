"""Factorization-free PSD projection via polynomial filtering.

``eigh`` is the pacing kernel for SDP cone projections (SURVEY.md §7 "hard
parts"): it is a sequential factorization.  Following the idea of composite
polynomial filtering (see PAPERS.md: "Factorization-free Orthogonal
Projection onto the Positive Semidefinite Cone with Composite Polynomial
Filtering"), the projection

    P_{S+}(X) = (X + |X|) / 2,     |X| = X * sign(X)

is computed with a matrix-polynomial approximation of ``sign``: scale X so
its spectrum lies in [-1, 1], run a few accelerated (quintic) Newton-Schulz
iterations followed by cubic polishing — every operation is a batched
matmul, i.e. dense-matmul work that vmaps over PSD blocks.

Accuracy: the tuned schedule classifies eigenvalues with |lambda| >= ~1e-4
* ||X||_2 essentially exactly; eigenvalues below that threshold contribute
at most their own magnitude to the projection error.  Which method
``psd_method="auto"`` picks is decided in
:func:`fos_tpu.cones.project.resolve_psd_method`.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# Quintic iteration coefficients (composite polynomial acceleration in the
# flat region near 0): z <- a z + b z^3 + c z^5 keeps |z|<=1 and expands
# small |z| aggressively; finish with pure cubic NS for contraction to ±1.
_QUINTIC = (3.4445, -4.7750, 2.0315)

# Per-iteration tuned schedule (round 5): greedy minimax design — each
# quintic maximizes the post-iterate lower bound over the current spectrum
# interval subject to max p <= 0.9999 (overshoot guard), starting from
# [1e-4, 1]; two cubic polish steps finish to |f(z)-1| <= 1e-13 (f64
# scalar).  9 quintics + 2 cubics = 31 matmuls vs the uniform schedule's
# 10 + 12 = 54 at the SAME classification threshold (f32 matrix A/B at
# d=512: max|P - P_eigh| 5.2e-7 new vs 4.4e-7 old on gauss spectra,
# 5.0e-7 vs 2.8e-7 with planted 1e-4-scale eigenvalues).
_SCHEDULE = np.array([
    (3.346018, -6.177797, 2.993520),
    (3.347131, -6.184793, 3.002299),
    (3.259782, -5.968771, 3.709233),
    (3.394741, -6.413290, 3.037562),
    (3.707931, -8.532502, 5.699246),
    (3.721769, -8.566419, 5.461109),
    (3.581464, -7.764542, 5.178028),
    (2.197576, -1.888380, 0.625264),
    (2.005234, -1.523195, 0.517864),
])
_SCHEDULE_CUBICS = 2


def _mm(a, b):
    # full f32: without a precision an f32 matmul on the GPU may run in
    # TF32 (about three decimal digits), and the sign iteration needs f32
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _matrix_sign(Y, quintic_iters, cubic_iters):
    def quintic(Z, coef):
        a, b, c = coef
        Z2 = _mm(Z, Z)
        Z3 = _mm(Z2, Z)
        Z5 = _mm(Z2, Z3)
        return a * Z + b * Z3 + c * Z5, None

    def cubic(Z, _):
        return 1.5 * Z - 0.5 * _mm(_mm(Z, Z), Z), None

    if quintic_iters is None:  # tuned per-iteration schedule (default)
        coefs = jnp.asarray(_SCHEDULE, Y.dtype)
        cubics = _SCHEDULE_CUBICS
    else:  # legacy uniform schedule (explicit iteration counts)
        coefs = jnp.tile(jnp.asarray(_QUINTIC, Y.dtype)[None],
                         (quintic_iters, 1))
        cubics = cubic_iters
    Z, _ = jax.lax.scan(quintic, Y, coefs)
    Z, _ = jax.lax.scan(cubic, Z, None, length=cubics)
    return Z


def _spectral_bound(X, iters: int = 8):
    """Tight upper estimate of ||X||_2: power iteration with safety margin,
    clipped by the Frobenius bound.  Scaling by the loose Frobenius norm
    shrinks the spectrum by ~sqrt(d), starving the sign iteration's
    convergence for small eigenvalues."""
    d = X.shape[-1]
    fro = jnp.linalg.norm(X, axis=(-2, -1), keepdims=True)
    # float(): np.float64 is a *strong* scalar — under jax_enable_x64 it
    # silently promotes the whole power iteration (and everything downstream
    # in psd_project_poly) to f64.
    v = jnp.ones((*X.shape[:-1], 1), X.dtype) / float(np.sqrt(d))

    def body(v, _):
        w = _mm(X, v)
        w = _mm(X, w)  # X^2 v: converges on |lambda|_max regardless of sign
        return w / jnp.maximum(jnp.linalg.norm(w, axis=(-2, -1), keepdims=True), 1e-30), None

    v, _ = jax.lax.scan(body, v, None, length=iters)
    lam = jnp.linalg.norm(_mm(X, v), axis=(-2, -1), keepdims=True)
    est = jnp.minimum(1.1 * lam, fro)
    return jnp.where(est > 0, est, 1.0)


def psd_project_poly(X, *, quintic_iters=None, cubic_iters=None):
    """Project symmetric ``X`` (..., d, d) onto the PSD cone, matmul-only.

    Default (``quintic_iters=None``): the tuned 31-matmul per-iteration
    schedule (``_SCHEDULE``).  Passing explicit ``quintic_iters`` /
    ``cubic_iters`` selects the legacy uniform schedule."""
    R = _spectral_bound(X)
    Y = X / R
    Z = _matrix_sign(Y, quintic_iters, cubic_iters)
    absX = _mm(X, Z)  # = |X| up to the sign-approximation error (X, Z commute)
    Xp = 0.5 * (X + absX)
    # symmetrize (the iteration preserves symmetry only up to rounding)
    return 0.5 * (Xp + jnp.swapaxes(Xp, -1, -2))
