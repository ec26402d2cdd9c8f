"""Affine-subspace projectors (the S1 sets of the solvers).

These are the equivalents of the reference's two S1 back ends:

* indirect — warm-started CG with the decreasing-accuracy schedule
  (affinepluslinear.jl:83-126, HSDEAffine.jl:105-126), here on SPD
  reductions (see :mod:`fos_tpu.linalg.hsde_ops`);
* direct — the reference caches a QR factorization inside ProximalOperators'
  ``IndAffine`` (HSDE.jl:15); here we likewise QR-factorize the least-squares
  operator (``[I; Q]`` resp. ``[A'; I]``) and cache ``P = Q_f R^{-T}`` so
  each projection is ONE GEMV that touches the conditioning once — a
  Cholesky of the normal matrix ``I + Q'Q`` squares ``sigma_max(Q)``
  (measured: 2e-3 vs 2e-10 u-error at cond(A) = 1e7 with sigma_max = 1e7,
  tests/test_linalg.py), the same failure the AffineSet QR fix addressed
  (sets/sets.py).

Projector classes are registered pytrees: their arrays travel through
``jit``/``vmap``/``pjit`` as ordinary inputs, and all mutable reference
state (warm starts, call counters, cg telemetry — ``CGdata``/``S.i``/
``S.cgiter`` in the reference) lives in an explicit :class:`CGState` carried
in the solver state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fos_tpu.linalg import hsde_ops
from fos_tpu.linalg.hsde_ops import PREC as _PREC  # full-f32 matmuls (no TF32)
from fos_tpu.linalg.cg import (CGState, conjugate_gradient,
                               conjugate_gradient_pipelined,
                               conjugate_gradient_tracked,
                               decreasing_tolerance)


def _host_q_dense_f64(A, b, c):
    """Materialize Q on HOST in f64 (mirrors hsde_ops.q_dense) — the
    direct-mode build factors it on the host anyway, so this skips a device
    jit compile and a fetch of the dense Q."""
    import numpy as np

    if hasattr(A, "todense") and not isinstance(A, jnp.ndarray):
        A = A.todense()
    Ah = np.asarray(jax.device_get(A), np.float64)
    bh = np.asarray(jax.device_get(b), np.float64)
    ch = np.asarray(jax.device_get(c), np.float64)
    m, n = Ah.shape
    l = m + n + 1
    Q = np.zeros((l, l))
    Q[:n, n:n + m] = Ah.T
    Q[:n, -1] = ch
    Q[n:n + m, :n] = -Ah
    Q[n:n + m, -1] = bh
    Q[-1, :n] = -ch
    Q[-1, n:n + m] = -bh
    return Q


def _ls_projection_fac(Mtop, *, eye_first, out_dtype=None):
    """Cached least-squares map ``P = Q_f R^{-T}`` of ``QR([I; Mtop])``
    (``eye_first=True``), ``QR([Mtop; I])`` (``eye_first=False``), or
    ``QR(Mtop)`` with no identity stack (``eye_first=None``).

    The reference pays one host sparse QR at load time (HSDE.jl:15 via
    ProximalOperators' ``IndAffine``); when ``Mtop`` is a concrete array we
    factor on HOST in f64 (strictly more accurate than an in-dtype device
    QR: representation error only, the factorization itself is f64) and
    cast the result once.  Under tracing (jit/vmap — e.g. re-sharding a
    built form) we fall back to the device QR, which is the only option.
    """
    import numpy as np

    if isinstance(Mtop, jax.core.Tracer):
        from jax.scipy.linalg import solve_triangular

        k = Mtop.shape[-1]

        def _fac(Mi):
            eye = jnp.eye(k, dtype=Mi.dtype)
            if eye_first is None:
                M = Mi
            elif eye_first:
                M = jnp.concatenate([eye, Mi], axis=0)
            else:
                M = jnp.concatenate([Mi, eye], axis=0)
            Qf, R = jnp.linalg.qr(M, mode="reduced")
            return jnp.matmul(Qf, solve_triangular(R.T, eye, lower=True),
                              precision=_PREC)

        return jax.vmap(_fac)(Mtop) if Mtop.ndim == 3 else _fac(Mtop)

    import scipy.linalg

    Mh = np.asarray(jax.device_get(Mtop), dtype=np.float64)
    batched = Mh.ndim == 3
    if not batched:
        Mh = Mh[None]
    k = Mh.shape[-1]
    eye = np.eye(k)
    out = np.empty((Mh.shape[0], Mh.shape[1] + (0 if eye_first is None else k), k))
    for i in range(Mh.shape[0]):
        if eye_first is None:
            M = Mh[i]
        else:
            M = np.zeros((Mh.shape[1] + k, k))
            sl = slice(0, k) if eye_first else slice(Mh.shape[1], None)
            np.fill_diagonal(M[sl], 1.0)
            M[slice(k, None) if eye_first else slice(0, Mh.shape[1])] = Mh[i]
        Qf, R = scipy.linalg.qr(M, mode="economic", check_finite=False,
                                overwrite_a=eye_first is not None)
        out[i] = Qf @ scipy.linalg.solve_triangular(R.T, eye, lower=True,
                                                    check_finite=False)
    if not batched:
        out = out[0]
    if out_dtype is None:
        out_dtype = jnp.asarray(Mtop).dtype if not isinstance(Mtop, np.ndarray) \
            else jnp.zeros((), Mtop.dtype).dtype  # canonicalized (x64 gating)
    return jnp.asarray(out, dtype=out_dtype)


def _cum(total, iters):
    """Accumulate CGState.total_iters telemetry (None-safe for states built
    positionally without the field)."""
    return None if total is None else total + iters


def _default_floor(size: int, dtype) -> float:
    """CG absolute-tolerance floor: the reference's ``size*eps``
    (affinepluslinear.jl:108).  At f32 and large size this is ~1e-3
    ABSOLUTE — loose enough to stall accuracy-limited problems (the
    batched lambda-min SDP sits at d~1e-3 forever; sqrt(size)*eps
    converges it in the same 500 iterations as f64, measured round 4) —
    but a blanket-tight default costs 2.5-3.5x throughput on easy LPs
    (more CG iterations per outer step from ~iteration 50 on).  So the
    default stays loose and the engines' on-device stall recovery
    tightens it per problem when residual progress plateaus before
    convergence (HSDEForm.plateau_stalled*)."""
    return size * float(jnp.finfo(dtype).eps)


@jax.tree_util.register_pytree_node_class
class HSDEAffineProjector:
    """Projection onto ``{(u, v) : Q u = v}`` for the HSDE operator Q.

    Replaces ``prox!(y, ::HSDEMatrix, x)`` (HSDEAffine.jl:105-126) and the
    direct ``IndAffine([Q -I])`` path (HSDE.jl:15).
    """

    #: the projection map is affine in z (line-search probe cache,
    #: wrappers.py); the HSDE set {(u, v): Qu = v} is a SUBSPACE, so the
    #: map is linear (no constant term)
    projection_is_affine = True
    projection_offset_free = True

    def __init__(self, A, b, c, fac=None, *, direct=False, decreasing_accuracy=True,
                 cg_max_iters=1000, tol_floor=None, cg_variant="standard",
                 cg_unroll=2, compensated=False):
        self.A = A
        self.b = b
        self.c = c
        self.fac = fac  # (2l, l) P = Q_f R^{-T} of QR([I; Q]) (direct mode)
        self.direct = direct
        self.decreasing_accuracy = decreasing_accuracy
        self.cg_max_iters = cg_max_iters
        self.tol_floor = tol_floor
        self.cg_variant = cg_variant
        self.cg_unroll = cg_unroll
        self.compensated = compensated

    # -- pytree protocol --------------------------------------------------
    def tree_flatten(self):
        return (self.A, self.b, self.c, self.fac), (
            self.direct,
            self.decreasing_accuracy,
            self.cg_max_iters,
            self.tol_floor,
            self.cg_variant,
            self.cg_unroll,
            self.compensated,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, b, c, fac = children
        (direct, decreasing, cg_max, tol_floor, cg_variant, cg_unroll,
         compensated) = aux
        return cls(A, b, c, fac, direct=direct, decreasing_accuracy=decreasing,
                   cg_max_iters=cg_max, tol_floor=tol_floor, cg_variant=cg_variant,
                   cg_unroll=cg_unroll, compensated=compensated)

    # ---------------------------------------------------------------------
    @classmethod
    def create(cls, A, b, c, *, direct=False, decreasing_accuracy=True,
               cg_max_iters=1000, tol_floor=None, cg_variant="standard",
               cg_unroll=2, compensated=False):
        fac = None
        if direct:
            # u = argmin ||[I; Q] u - z||^2 (normal eq: (I + Q'Q) u = u0 + Q'v0).
            # QR of M = [I; Q] touches cond(M) = O(sigma_max(Q)) once;
            # P = Q_f R^{-T} gives u = P' z in one GEMV.  Factored on host
            # in f64 when concrete (see _ls_projection_fac); Q itself is
            # also built on host then (skips a device compile + fetch).
            leaves = jax.tree_util.tree_leaves((A, b, c))
            if any(isinstance(x, jax.core.Tracer) for x in leaves):
                fac = _ls_projection_fac(hsde_ops.q_dense(A, b, c),
                                         eye_first=True)
            else:
                fac = _ls_projection_fac(
                    _host_q_dense_f64(A, b, c), eye_first=True,
                    out_dtype=jnp.asarray(b).dtype)
        return cls(A, b, c, fac, direct=direct,
                   decreasing_accuracy=decreasing_accuracy,
                   cg_max_iters=cg_max_iters, tol_floor=tol_floor,
                   cg_variant=cg_variant, cg_unroll=cg_unroll,
                   compensated=compensated)

    @property
    def l(self) -> int:
        return self.b.shape[0] + self.c.shape[0] + 1

    @property
    def dim(self) -> int:
        return 2 * self.l

    def init_cg_state(self, dtype) -> CGState:
        return CGState.create(self.l, dtype)

    init_state = init_cg_state  # set-protocol alias (solvers.base.TwoSets)

    def init_state_from(self, z0) -> CGState:
        """Warm-start state seeded from the initial iterate: ``warm = u0``
        (the reference's first-run seed) plus ``v_warm = Q u0``, paying ONE
        q_mul at init time so every projection afterwards forms its CG
        residual with a single fused A-pass (see :class:`CGState.v_warm`).
        Direct mode and the pipelined CG variant never read ``v_warm``;
        they keep the dtype-only state."""
        if self.direct or self.cg_variant == "pipelined":
            return self.init_cg_state(z0.dtype)
        u0 = z0[: self.l]
        return CGState.create(self.l, z0.dtype)._replace(
            warm=u0, v_warm=hsde_ops.q_mul(self.A, self.b, self.c, u0),
            initialized=jnp.asarray(True))

    def refresh_state(self, cg: CGState) -> CGState:
        """Re-anchor the tracked invariant ``v_warm = Q warm`` with one
        fresh matvec.  The incremental ``Qx += alpha * Qp`` track
        accumulates a rounding random-walk across outer iterations (~
        sqrt(k) * eps(f32) relative), which at tight eps (1e-7, f32)
        displaces the DR fixed point enough to stall; the engines call
        this once per check chunk, bounding the walk to ``checki`` steps
        for one amortized A-pass per chunk."""
        if getattr(cg, "v_warm", None) is None:
            return cg
        return cg._replace(
            v_warm=hsde_ops.q_mul(self.A, self.b, self.c, cg.warm))

    def project(self, z, cg: CGState):
        l = self.l
        u0 = z[:l]
        v0 = z[l:]
        if self.direct:
            # full f32: at a reduced input precision (TF32 on the GPU)
            # this GEMV displaces the DR fixed point enough to prevent
            # convergence at eps=1e-5 on hard LP batches
            u = jnp.matmul(self.fac.T, z, precision=_PREC)
            new_cg = cg._replace(call_idx=cg.call_idx + 1,
                                 last_iters=jnp.asarray(0, jnp.int32))
        else:
            tracked = cg.v_warm is not None and self.cg_variant != "pipelined"
            if tracked:
                # One fused A-pass for the initial residual, using the
                # carried invariant v_warm = Q warm and skew-symmetry:
                #   r0 = rhs - (I + Q'Q) warm
                #      = u0 - Q v0 - warm - Q'(Q warm)
                #      = u0 - Q(v0 - v_warm) - warm.
                warm = cg.warm
                r0 = (u0 - hsde_ops.q_mul(self.A, self.b, self.c,
                                          v0 - cg.v_warm) - warm)
            else:
                # legacy path (pipelined variant, or states created without
                # v_warm — e.g. checkpoints from older runs)
                # rhs = u0 + Q' v0 = u0 - Q v0 (skew-symmetry)
                rhs = u0 - hsde_ops.q_mul(self.A, self.b, self.c, v0)
                warm = jnp.where(cg.initialized, cg.warm, u0)
            # reference floor: size(KKT,2)*eps = 2l*eps
            # (affinepluslinear.jl:108) — an f64 formula that is ~1e-3
            # ABSOLUTE at f32/large l and can stall whole problem classes
            # (the batched lambda-min SDP, round 4).  The DEFAULT stays
            # loose anyway (a blanket-tight floor costs 2.5-3.5x on easy
            # LPs); the engines' budget-aware stall recovery tightens it
            # per problem via the traced cg.floor, which takes precedence
            # over both the default and an explicit tol_floor.
            if cg.floor is not None:
                floor = cg.floor
            elif self.tol_floor is not None:
                floor = self.tol_floor
            else:
                floor = _default_floor(2 * l, z.dtype)  # KKT size = 2l
            if self.decreasing_accuracy:
                tol = decreasing_tolerance(cg.call_idx, floor, z.dtype)
            else:
                tol = jnp.asarray(floor, z.dtype)
            if tracked:
                res = conjugate_gradient_tracked(
                    lambda x: hsde_ops.q_mul(self.A, self.b, self.c, x),
                    r0, warm, cg.v_warm, tol=tol,
                    max_iters=self.cg_max_iters, unroll=self.cg_unroll,
                    compensated=self.compensated,
                )
                new_cg = cg._replace(warm=res.x, v_warm=res.Qx,
                                     initialized=jnp.asarray(True),
                                     call_idx=cg.call_idx + 1,
                                     last_iters=res.iters,
                                 total_iters=_cum(cg.total_iters, res.iters))
                return jnp.concatenate([res.x, res.Qx]), new_cg
            if self.cg_variant == "pipelined":
                res = conjugate_gradient_pipelined(
                    lambda x: hsde_ops.hsde_normal_mul(self.A, self.b, self.c, x),
                    rhs, warm, tol=tol, max_iters=self.cg_max_iters,
                )
            else:
                res = conjugate_gradient(
                    lambda x: hsde_ops.hsde_normal_mul(self.A, self.b, self.c, x),
                    rhs, warm, tol=tol, max_iters=self.cg_max_iters,
                    unroll=self.cg_unroll, compensated=self.compensated,
                )
            u = res.x
            new_cg = cg._replace(warm=u, initialized=jnp.asarray(True),
                                 call_idx=cg.call_idx + 1,
                                 last_iters=res.iters,
                                 total_iters=_cum(cg.total_iters, res.iters))
        v = hsde_ops.q_mul(self.A, self.b, self.c, u)
        return jnp.concatenate([u, v]), new_cg


@jax.tree_util.register_pytree_node_class
class AffinePlusLinearProjector:
    """Prox of ``f([x; z]) = q'x + ind(Ax - beta*z = b)`` with ``beta = ±1``.

    Reference: ``AffinePlusLinear`` (affinepluslinear.jl:58-126).  Solved via
    the m x m SPD system ``(I + AA') lam = A(x1 - q) - beta*x2 - b`` with
    ``y1 = x1 - q - A'lam`` and ``y2 = x2 + beta*lam``.
    """

    #: affine projection map (offset from b and q) — probe cache eligible
    projection_is_affine = True
    projection_offset_free = False

    def __init__(self, A, b, q, beta: int, fac=None, *, direct=False,
                 decreasing_accuracy=False, cg_max_iters=1000):
        assert beta in (1, -1)
        self.A = A
        self.b = b
        self.q = q
        self.beta = beta
        self.fac = fac  # (n+m, m) P = Q_f R^{-T} of QR([A'; I]) (direct mode)
        self.direct = direct
        self.decreasing_accuracy = decreasing_accuracy
        self.cg_max_iters = cg_max_iters

    def tree_flatten(self):
        return (self.A, self.b, self.q, self.fac), (
            self.beta, self.direct, self.decreasing_accuracy, self.cg_max_iters)

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, b, q, fac = children
        beta, direct, decreasing, cg_max = aux
        return cls(A, b, q, beta, fac, direct=direct,
                   decreasing_accuracy=decreasing, cg_max_iters=cg_max)

    @classmethod
    def create(cls, A, b, q, beta, *, direct=False, decreasing_accuracy=False,
               cg_max_iters=1000):
        fac = None
        if direct:
            # lam = argmin ||[A'; I] lam - [x1-q; -(beta x2 + b)]||^2
            # (normal eq: (I + AA') lam = A(x1-q) - beta x2 - b); QR of
            # N = [A'; I] touches cond once (vs squared via Cholesky).
            # Factored on host in f64 when concrete (_ls_projection_fac).
            Ad = A.todense() if hasattr(A, "todense") else A
            fac = _ls_projection_fac(Ad.T, eye_first=False)
        return cls(A, b, q, beta, fac, direct=direct,
                   decreasing_accuracy=decreasing_accuracy, cg_max_iters=cg_max_iters)

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def n(self) -> int:
        return self.q.shape[0]

    @property
    def dim(self) -> int:
        return self.m + self.n

    def init_cg_state(self, dtype) -> CGState:
        return CGState.create(self.m, dtype)

    init_state = init_cg_state  # set-protocol alias (solvers.base.TwoSets)

    def project(self, x, cg: CGState):
        n = self.n
        x1 = x[:n]
        x2 = x[n:]
        if self.direct:
            zls = jnp.concatenate([x1 - self.q, -(self.beta * x2 + self.b)])
            lam = jnp.matmul(self.fac.T, zls, precision=_PREC)
            new_cg = cg._replace(call_idx=cg.call_idx + 1,
                                 last_iters=jnp.asarray(0, jnp.int32))
        else:
            rhs = hsde_ops.mv(self.A, x1 - self.q) - self.beta * x2 - self.b
            warm = jnp.where(cg.initialized, cg.warm, jnp.zeros_like(rhs))
            floor = (self.m + self.n) * jnp.finfo(x.dtype).eps
            if self.decreasing_accuracy:
                tol = decreasing_tolerance(cg.call_idx, floor, x.dtype)
            else:
                tol = jnp.asarray(floor, x.dtype)
            res = conjugate_gradient(
                lambda lam: hsde_ops.kkt_normal_mul(self.A, lam),
                rhs, warm, tol=tol, max_iters=self.cg_max_iters,
            )
            lam = res.x
            new_cg = cg._replace(warm=lam, initialized=jnp.asarray(True),
                                 call_idx=cg.call_idx + 1,
                                 last_iters=res.iters,
                                 total_iters=_cum(cg.total_iters, res.iters))
        y1 = x1 - self.q - hsde_ops.rmv(self.A, lam)
        y2 = x2 + self.beta * lam
        return jnp.concatenate([y1, y2]), new_cg
