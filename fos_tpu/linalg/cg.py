"""Conjugate gradients as a compiled ``lax.while_loop``.

Counterpart of the reference's preallocated, warm-started CG
(/root/reference/src/utilities/conjugategradients.jl:31-55, Golub & Van Loan
form).  Differences by design:

* the loop is a ``lax.while_loop`` — no host round-trips, usable inside an
  outer jitted solver loop and under ``vmap``/``pjit``;
* warm-start state is an explicit immutable :class:`CGState` pytree threaded
  through the solver state instead of mutable ``CGdata`` buffers
  (conjugategradients.jl:1-11);
* the two dot products per iteration are ``jnp.vdot`` calls, which XLA/GSPMD
  turns into ``psum``-reduced partial dots when the vectors are sharded
  (SURVEY.md §5 "Distributed communication backend").
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray      # int32 — matches the reference's returned iter count
    rnorm: jnp.ndarray      # final residual norm


class CGState(NamedTuple):
    """Warm-start state carried between prox calls.

    Mirrors the role of ``CGdata.xinit``/``firstrun``
    (conjugategradients.jl:1-11, affinepluslinear.jl:100-122).
    ``call_idx`` counts prox invocations and drives the decreasing-accuracy
    tolerance schedule (affinepluslinear.jl:108-112); ``last_iters`` is the
    ``cgiter`` telemetry surfaced in the status table (HSDEStatus.jl:45-47).
    """

    warm: jnp.ndarray
    initialized: jnp.ndarray   # bool scalar
    call_idx: jnp.ndarray      # int32, starts at 1 like the reference's S.i
    last_iters: jnp.ndarray    # int32
    #: optional TRACED tolerance-floor override (fused-path gap-stall
    #: recovery tightens it on device mid-solve); None -> the projector's
    #: static tol_floor applies
    floor: Any = None
    #: optional TRACED plateau-recovery baseline (the stall score one
    #: window ago) — lives here, like ``floor``, so it survives segmented
    #: fused solves (resume_state carries the whole CGState)
    win_score: Any = None
    #: cumulative CG iterations across all projection calls (int32) —
    #: telemetry for traffic models (A-passes/outer-iteration = 1 + 2*kbar
    #: on the tracked HSDE path) and perf analysis; None for states built
    #: positionally by other sets
    total_iters: Any = None
    #: ``Q @ warm`` carried alongside the warm start (HSDE S1 projector):
    #: lets the next projection form its initial CG residual as
    #: ``r0 = u0 - Q(v0 - v_warm) - warm`` (ONE fused A-pass) instead of
    #: rhs-build + normal-matvec (three), and makes the output ``v = Q u``
    #: free via the tracked recurrence ``Qx += alpha * Qp`` — 4 + 2k fused
    #: A-passes per outer iteration become 1 + 2k (None -> legacy path)
    v_warm: Any = None

    @staticmethod
    def create(size: int, dtype) -> "CGState":
        return CGState(
            warm=jnp.zeros(size, dtype=dtype),
            initialized=jnp.asarray(False),
            call_idx=jnp.asarray(1, jnp.int32),
            last_iters=jnp.asarray(0, jnp.int32),
            total_iters=jnp.asarray(0, jnp.int32),
        )


def conjugate_gradient(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray,
    *,
    tol,
    max_iters: int,
    unroll: int = 1,
    compensated: bool = False,
) -> CGResult:
    """Solve ``matvec(x) == b`` from warm start ``x0``.

    Semantics match conjugategradients.jl:31-55: absolute tolerance on
    ``||r||``, iteration count returned.

    ``compensated`` computes the two dot products per iteration with
    float-float (error-free-transform) arithmetic
    (:mod:`fos_tpu.linalg.compensated`) — ~f64-quality alpha/beta scalars in
    pure f32, removing the reduction-roundoff stall that otherwise caps
    warm-started f32 CG around 1e-4 residuals.

    ``unroll`` performs that many CG iterations per while-loop step (the
    tolerance is checked once per group): every loop step pays a fixed
    device-loop overhead, which dominates when the warm-started CG needs
    only a couple of iterations.  The extra sub-iterations past
    convergence are guarded (zero steps), so the result is unchanged up to
    a few sub-tolerance iterations.
    """

    if compensated:
        from fos_tpu.linalg.compensated import cdot as _dot
    else:
        _dot = jnp.vdot

    r0 = b - matvec(x0)
    rn0 = _dot(r0, r0)
    tol2 = jnp.asarray(tol, b.dtype) ** 2

    def cond(state):
        _, _, _, rn, it = state
        return (rn > tol2) & (it < max_iters)

    def one(state):
        x, r, p, rn, it = state
        live = rn > tol2
        Ap = matvec(p)
        den = _dot(Ap, p)
        alpha = jnp.where(live & (den != 0), rn / jnp.where(den != 0, den, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rn_new = _dot(r, r)
        beta = jnp.where(live, rn_new / jnp.where(rn > 0, rn, 1.0), 0.0)
        p = jnp.where(live, r + beta * p, p)
        rn_out = jnp.where(live, rn_new, rn)
        return (x, r, p, rn_out, it + live.astype(jnp.int32))

    def body(state):
        for _ in range(unroll):
            state = one(state)
        return state

    x, _, _, rn, iters = jax.lax.while_loop(cond, body, (x0, r0, r0, rn0, jnp.asarray(0, jnp.int32)))
    return CGResult(x=x, iters=iters, rnorm=jnp.sqrt(rn))


class CGTrackedResult(NamedTuple):
    x: jnp.ndarray
    Qx: jnp.ndarray         # Q @ x, tracked through the recurrence
    iters: jnp.ndarray
    rnorm: jnp.ndarray


def conjugate_gradient_tracked(
    q_fn: Callable[[jnp.ndarray], jnp.ndarray],
    r0: jnp.ndarray,
    x0: jnp.ndarray,
    Qx0: jnp.ndarray,
    *,
    tol,
    max_iters: int,
    unroll: int = 1,
    compensated: bool = False,
) -> CGTrackedResult:
    """CG on the HSDE normal operator ``M = I + Q'Q`` that tracks ``Q x``.

    The caller supplies the initial residual ``r0 = rhs - M(x0)`` (cheaply,
    via the skew-symmetry identity — see :class:`CGState`) and ``Qx0 =
    Q @ x0``.  Each iteration computes ``Qp`` once and reuses it for both
    ``M p = p - Q(Q p)`` and the ``Qx += alpha * Qp`` track, so the final
    ``v = Q u`` costs no extra matvec.  Identical x/r/p arithmetic to
    :func:`conjugate_gradient` on the same operator.
    """
    if compensated:
        from fos_tpu.linalg.compensated import cdot as _dot
    else:
        _dot = jnp.vdot

    rn0 = _dot(r0, r0)
    tol2 = jnp.asarray(tol, r0.dtype) ** 2

    def cond(state):
        _, _, _, _, rn, it = state
        return (rn > tol2) & (it < max_iters)

    def one(state):
        x, Qx, r, p, rn, it = state
        live = rn > tol2
        Qp = q_fn(p)
        Ap = p - q_fn(Qp)
        den = _dot(Ap, p)
        alpha = jnp.where(live & (den != 0), rn / jnp.where(den != 0, den, 1.0), 0.0)
        x = x + alpha * p
        Qx = Qx + alpha * Qp
        r = r - alpha * Ap
        rn_new = _dot(r, r)
        beta = jnp.where(live, rn_new / jnp.where(rn > 0, rn, 1.0), 0.0)
        p = jnp.where(live, r + beta * p, p)
        rn_out = jnp.where(live, rn_new, rn)
        return (x, Qx, r, p, rn_out, it + live.astype(jnp.int32))

    def body(state):
        for _ in range(unroll):
            state = one(state)
        return state

    x, Qx, _, _, rn, iters = jax.lax.while_loop(
        cond, body, (x0, Qx0, r0, r0, rn0, jnp.asarray(0, jnp.int32)))
    return CGTrackedResult(x=x, Qx=Qx, iters=iters, rnorm=jnp.sqrt(rn))


def conjugate_gradient_pipelined(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray,
    *,
    tol,
    max_iters: int,
) -> CGResult:
    """Chronopoulos–Gear CG: one matvec and ONE fused reduction per iteration.

    Communication-reduced variant for sharded meshes (see PAPERS.md,
    "Communication-reduced Conjugate Gradient Variants"): the two dot
    products of standard CG are replaced by a single simultaneous reduction
    of ``(r·r, r·Ar)``, halving the collective latency per iteration when
    the vectors are sharded.  Mathematically equivalent to standard CG in
    exact arithmetic; slightly less stable in floating point (the alpha
    recurrence), which the decreasing-accuracy outer schedule tolerates.
    """
    r0 = b - matvec(x0)
    w0 = matvec(r0)
    # one fused reduction of both scalars
    gd0 = jnp.stack([jnp.vdot(r0, r0), jnp.vdot(r0, w0)])
    gamma0, delta0 = gd0[0], gd0[1]
    tol2 = jnp.asarray(tol, b.dtype) ** 2
    alpha0 = jnp.where(delta0 != 0, gamma0 / delta0, 0.0)

    def cond(state):
        _, _, _, _, _, gamma, _, _, it = state
        return (gamma > tol2) & (it < max_iters)

    def body(state):
        x, r, w, p, s, gamma, alpha, beta, it = state
        p = r + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        w = matvec(r)
        gd = jnp.stack([jnp.vdot(r, r), jnp.vdot(r, w)])
        gamma_new, delta_new = gd[0], gd[1]
        beta_new = gamma_new / gamma
        denom = delta_new - beta_new * gamma_new / alpha
        alpha_new = jnp.where(denom != 0, gamma_new / denom, 0.0)
        return (x, r, w, p, s, gamma_new, alpha_new, beta_new, it + 1)

    zero = jnp.zeros_like(b)
    x, r, _, _, _, gamma, _, _, iters = jax.lax.while_loop(
        cond, body,
        (x0, r0, w0, zero, zero, gamma0, alpha0, jnp.asarray(0.0, b.dtype),
         jnp.asarray(0, jnp.int32)),
    )
    return CGResult(x=x, iters=iters, rnorm=jnp.sqrt(gamma))


def decreasing_tolerance(call_idx, floor, dtype):
    """The reference's decreasing-accuracy schedule ``max(0.2^sqrt(i), floor)``
    (affinepluslinear.jl:108-112)."""
    i = call_idx.astype(dtype)
    return jnp.maximum(jnp.asarray(0.2, dtype) ** jnp.sqrt(i), jnp.asarray(floor, dtype))
