"""Matrix-free operators for the homogeneous self-dual embedding.

The HSDE matrix (HSDEAffine.jl:2-65 in the reference)

    Q = [ 0    A'   c ]
        [-A    0    b ]
        [-c'  -b'   0 ]

is skew-symmetric (Q' = -Q); one application costs one ``A`` matvec, one
``A'`` matvec and rank-1 ``b``/``c`` terms.

Redesign of the affine projection: instead of running CG on the
reference's 2l x 2l symmetric-indefinite system ``[I Q'; Q -I]``
(HSDEAffine.jl:105-126), project onto ``{(u,v): Qu = v}`` by solving the
l x l SPD system

    (I + Q'Q) u = u0 + Q' v0        (= u0 - Q v0 by skewness)

and setting ``v = Q u``.  Same two-projections-per-iteration semantics,
half the CG state, an SPD operator (plain CG is actually guaranteed to
converge, unlike on the indefinite form), and the matvec is two Q
applications, each one ``(A @ x, A' @ z)`` pair plus rank-1 terms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jax.experimental import sparse as jsparse

# Dense solver matvecs run at full f32 precision: without a precision, an
# f32 product on the GPU may run in TF32 (about three decimal digits),
# which caps the achievable S1-projection accuracy and stalls
# dual-residual convergence on SDPs.  Matvecs are bound by memory
# bandwidth, so full precision costs next to nothing on the wall clock.
PREC = jax.lax.Precision.HIGHEST
_PREC = PREC  # backward-compat alias


def _dense_mv(A, x):
    return jnp.matmul(A, x, precision=_PREC)


def mv(A, x):
    """A @ x for dense, BCOO, or operator A (``mv`` protocol)."""
    if hasattr(A, "mv"):
        return A.mv(x)
    if isinstance(A, jsparse.BCOO):
        return A @ x
    return _dense_mv(A, x)


def rmv(A, y):
    """A' @ y for dense, BCOO, or operator A (``rmv`` protocol)."""
    if hasattr(A, "rmv"):
        return A.rmv(y)
    if isinstance(A, jsparse.BCOO):
        return A.T @ y
    return _dense_mv(A.T, y)


def mv_pair(A, x1, x2):
    """(A @ x1, A' @ x2); from the A tile table alone when A supports it
    (the sparse tile ops BlockedEllOp / BandedBlockOp / RowShardedOp)."""
    if hasattr(A, "mv_pair"):
        return A.mv_pair(x1, x2)
    if hasattr(A, "mv"):  # operator without a fused pair
        return A.mv(x1), A.rmv(x2)
    if isinstance(A, jsparse.BCOO):
        return A @ x1, A.T @ x2
    return _dense_mv(A, x1), _dense_mv(A.T, x2)


def q_mul(A, b, c, z):
    """Q @ z, matrix-free (one fused A/A' matvec pair + rank-1 terms).

    Mirrors the lazy ``mul!`` at HSDEAffine.jl:41-59.
    """
    n = c.shape[0]
    m = b.shape[0]
    z1 = z[:n]
    z2 = z[n : n + m]
    z3 = z[n + m]
    Az1, ATz2 = mv_pair(A, z1, z2)
    y1 = ATz2 + c * z3
    y2 = -Az1 + b * z3
    y3 = -jnp.vdot(c, z1) - jnp.vdot(b, z2)
    return jnp.concatenate([y1, y2, y3[None]])


def q_dense(A, b, c):
    """Materialize Q (for direct mode and test oracles)."""
    if isinstance(A, jsparse.BCOO) or (hasattr(A, "todense")
                                       and not isinstance(A, jnp.ndarray)):
        A = A.todense()
    n = c.shape[0]
    m = b.shape[0]
    top = jnp.concatenate([jnp.zeros((n, n), A.dtype), A.T, c[:, None]], axis=1)
    mid = jnp.concatenate([-A, jnp.zeros((m, m), A.dtype), b[:, None]], axis=1)
    bot = jnp.concatenate([-c[None, :], -b[None, :], jnp.zeros((1, 1), A.dtype)], axis=1)
    return jnp.concatenate([top, mid, bot], axis=0)


def hsde_normal_mul(A, b, c, u):
    """(I + Q'Q) u = u - Q(Q u), using the skew-symmetry of Q."""
    return u - q_mul(A, b, c, q_mul(A, b, c, u))


def kkt_normal_mul(A, lam):
    """(I + A A') lam — SPD reduction of the reference's ``[I A'; A -I]``
    KKT operator (affinepluslinear.jl:4-52)."""
    return lam + mv(A, rmv(A, lam))
