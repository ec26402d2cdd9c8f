"""Wrapper algorithms: line search and longstep.

Reference: /root/reference/src/wrappers/linesearch.jl, longstep.jl,
saveplanes.jl.  Wrappers are step-function combinators: they hold an inner
algorithm config and delegate, adding interval-gated extra work.  Both are
ordinary :class:`Algorithm` configs, so they compose with the same engine.

Reshaped for the device:

* the line-search candidate sweep (31 sequential prox evaluations with
  println debugging in the reference, linesearch.jl:54-70) becomes ONE
  vmapped batched evaluation of ``||T(x+a*res) - (x+a*res)||`` over the
  whole alpha grid;
* the longstep plane projection (a BigFloat QPDAS active-set QP in the
  reference, saveplanes.jl:13-55) becomes a fixed-iteration projected
  gradient on the tiny r-dimensional dual (r = 2*(nsave+1)) with the Gram
  matrix precomputed — jit-safe, f64, no host round-trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import jax
import jax.numpy as jnp

# full-f32 contractions: the plane-QP Gram and Anderson Gram contract over
# length-l iterates; a reduced input precision (TF32 on the GPU, ~1e-3
# relative) distorts tiny Gram systems built from near-parallel vectors.  These
# matmuls are O(r*l) / O(k*l) with r,k <= ~20 — HIGHEST is free here.
# One source of truth for the pinned precision: hsde_ops.PREC.
from fos_tpu.linalg.hsde_ops import PREC as _hi

from fos_tpu.linalg.cg import CGState
from fos_tpu.solvers.base import Algorithm, PlaneBuf, SolverState


def _advance_cg_calls(state, k: int):
    """Advance a CG-backed set state's call counter by ``k`` probe calls
    (no-op for stateless sets)."""
    if isinstance(state, CGState):
        return state._replace(call_idx=state.call_idx + k)
    return state


@dataclass(frozen=True)
class LineSearchWrapper(Algorithm):
    """Every ``lsinterval`` iterations: take one T = S2∘S1 step, set
    ``res = T(x) - x``, and grid-search ``alpha in 0.1*1.8^k, k=1..31``
    minimizing the fixed-point residual ``||T(x+alpha*res) - (x+alpha*res)||``
    (linesearch.jl:36-75)."""

    alg: Algorithm = None
    lsinterval: int = 100
    options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not self.alg.support_linesearch:
            raise ValueError(
                f"Algorithm {type(self.alg).__name__} does not support line search")

    def init_aux(self, x0):
        return self.alg.init_aux(x0)

    def coeffs(self, aux):
        return self.alg.coeffs(aux)

    def step(self, sets, st: SolverState) -> SolverState:
        inner = self.alg

        def ls_branch(st):
            x_prev = st.x
            tmp2, s1_state = inner.relaxed_s1(sets, st.x, st.s1_state, st.aux)
            z, x_new, s2_state = inner.relaxed_s2(sets, tmp2, st.s2_state, st.aux)
            res = x_new - x_prev

            alphas = 0.1 * 1.8 ** jnp.arange(1, 32, dtype=st.x.dtype)
            cands = x_prev[None, :] + alphas[:, None] * res[None, :]

            if (getattr(sets.s1, "projection_is_affine", False)
                    and getattr(sets.s1, "direct", False)):
                # gap.jl:42-51 constinit role: the relaxed S1 map is AFFINE,
                # so the 31 probe S1 projections collapse to 1-2 evaluations:
                # relaxed_s1(x + a*res) = relaxed_s1(x) + a*(relaxed_s1(res)
                # - relaxed_s1(0)), and relaxed_s1(x) = tmp2 is already in
                # hand from the real step.  Offset-free sets (the HSDE
                # subspace) skip the zero term entirely.  DIRECT mode only:
                # with CG projections the identity holds only to cg_tol, and
                # the extrapolation multiplies that error by alpha (up to
                # 0.1*1.8^31 ~ 8e6) — late-solve probes would misrank and
                # kick the iterate off the fixed point (measured: y1 error
                # 1e-5 -> 8e+1 across the grid); CG probes stay exact
                # per-candidate, as in the reference.
                s1_res, _ = inner.relaxed_s1(sets, res, s1_state, st.aux)
                if getattr(sets.s1, "projection_offset_free", False):
                    dirn = s1_res
                else:
                    s1_zero, _ = inner.relaxed_s1(
                        sets, jnp.zeros_like(res), s1_state, st.aux)
                    dirn = s1_res - s1_zero
                y1_cands = tmp2[None, :] + alphas[:, None] * dirn[None, :]

                def T2(y1c):
                    _, xc2, _ = inner.relaxed_s2(sets, y1c, s2_state, st.aux)
                    return xc2

                Tx = jax.vmap(T2)(y1_cands)
            else:
                def T(xc):
                    # NoStatus probes (linesearch.jl:58-63): warm-start state
                    # is shared read-only across candidates then discarded.
                    y1, _ = inner.relaxed_s1(sets, xc, s1_state, st.aux)
                    _, xc2, _ = inner.relaxed_s2(sets, y1, s2_state, st.aux)
                    return xc2

                Tx = jax.vmap(T)(cands)
            testres = jnp.linalg.norm(Tx - cands, axis=-1)
            abest = alphas[jnp.argmin(testres)]
            x_ls = x_prev + abest * res
            # The reference's prox! increments its call counter S.i on every
            # probe too (affinepluslinear.jl:113 runs under NoStatus), so the
            # decreasing-accuracy schedule sees all 31 probe calls; advance
            # call_idx to match.  The warm-start VECTOR intentionally stays
            # from the real step (the reference leaves the last probe's
            # solution, a worse warm start for the accepted iterate).
            s1_state = _advance_cg_calls(s1_state, len(alphas))
            s2_state = _advance_cg_calls(s2_state, len(alphas))
            return st._replace(
                x=x_ls, i=st.i + 1, z_check=z, z_check_prev=st.z_check,
                s1_state=s1_state, s2_state=s2_state,
            )

        def normal_branch(st):
            return inner.step(sets, st)

        do_ls = (st.i + 1) % self.lsinterval == 0
        return jax.lax.cond(do_ls, ls_branch, normal_branch, st)

    def getsol(self, sets, st):
        return self.alg.getsol(sets, st)

    @property
    def support_longstep(self):
        return False


def _project_on_planes(x, A, b, nsave: int, iters: int = 400):
    """Project x onto {y : A_eq y = b_eq} ∩ {y : C y <= d}.

    Rows [0..nsave] of (A, b) are equalities, the rest inequalities
    (saveplanes.jl semantics).  Solved in the r-dimensional dual
    ``min 1/2 th'G th - th'g0  s.t. th_ineq >= 0`` with
    ``y = x - A' th`` via accelerated projected gradient (FISTA) —
    the system is tiny (r = 2*(nsave+1)) so the Gram matrix is cheap.
    """
    r = A.shape[0]
    G = jnp.matmul(A, A.T, precision=_hi)
    g0 = jnp.matmul(A, x, precision=_hi) - b
    # Lipschitz bound: trace(G) >= lambda_max(G); guard zero planes.
    L = jnp.maximum(jnp.trace(G), 1e-30)
    ineq_mask = (jnp.arange(r) > nsave).astype(x.dtype)

    def proj_feasible(th):
        # equality multipliers free; inequality multipliers >= 0
        return jnp.where(ineq_mask > 0, jnp.maximum(th, 0.0), th)

    def body(carry, _):
        th, th_prev, t = carry
        t_new = (1.0 + jnp.sqrt(1.0 + 4.0 * t**2)) / 2.0
        w = th + ((t - 1.0) / t_new) * (th - th_prev)
        grad = jnp.matmul(G, w, precision=_hi) - g0
        th_next = proj_feasible(w - grad / L)
        return (th_next, th, t_new), None

    th0 = jnp.zeros(r, dtype=x.dtype)
    (th, _, _), _ = jax.lax.scan(body, (th0, th0, jnp.asarray(1.0, x.dtype)), None,
                                 length=iters)
    return x - jnp.matmul(A.T, th, precision=_hi)


@dataclass(frozen=True)
class AndersonWrapper(Algorithm):
    """Anderson acceleration (type II) of the wrapped algorithm's fixed-point
    iteration — the accelerator modern splitting solvers (SCS >= 3.0) ship;
    the reference has no equivalent.

    Keeps a ring buffer of the last ``memory`` (x_j, f_j = step(x_j) - x_j)
    pairs and replaces the iterate with the residual-minimizing affine
    combination ``x+ = sum a_j (x_j + f_j)``, ``sum a_j = 1``, solved from
    the regularized k x k Gram system.  Safeguard: if the step residual grew
    by more than ``safeguard`` since the previous iteration the memory is
    flushed and the plain step is used (jit-safe: everything is masked
    arithmetic, no host control flow).
    """

    alg: Algorithm = None
    memory: int = 10
    reg: float = 1e-10
    safeguard: float = 2.0
    adaptive: bool = True
    stall_window: int = 30
    stall_decay: float = 0.9
    options: Tuple[Tuple[str, Any], ...] = ()

    def init_aux(self, x0):
        k = self.memory
        dim = x0.shape[0]
        return (
            self.alg.init_aux(x0),
            jnp.zeros((k, dim), x0.dtype),            # X buffer
            jnp.zeros((k, dim), x0.dtype),            # F buffer
            jnp.asarray(0, jnp.int32),                # count (since last reset)
            jnp.asarray(jnp.inf, x0.dtype),           # previous residual norm
            jnp.full((self.stall_window,), jnp.inf, x0.dtype),  # fn history ring
            jnp.asarray(not self.adaptive),           # engaged flag
            jnp.asarray(0, jnp.int32),                # total step counter
        )

    def coeffs(self, aux):
        return self.alg.coeffs(aux[0])

    def step(self, sets, st: SolverState) -> SolverState:
        inner_aux, Xb, Fb, count, prev_fn, fnbuf, engaged, tstep = st.aux
        k = self.memory
        W = self.stall_window

        st_inner = st._replace(aux=inner_aux)
        st2 = self.alg.step(sets, st_inner)
        x_plain = st2.x
        f = x_plain - st.x
        fn = jnp.linalg.norm(f)

        # Adaptive engagement: AA only turns on once the plain iteration's
        # residual decay STALLS (fn has not decayed by stall_decay over the
        # last stall_window steps) — easy problems never pay AA's overhead
        # (PERF.md: plain DR beats always-on AA under ~1k iterations); on
        # hard problems AA engages with a freshly flushed memory.
        oldest = fnbuf[tstep % W]
        stalled = (tstep >= W) & (fn > self.stall_decay * oldest)
        newly_engaged = stalled & ~engaged
        engaged = engaged | stalled
        fnbuf = fnbuf.at[tstep % W].set(fn)
        tstep = tstep + 1

        # safeguard: residual grew too much -> flush memory, take plain step
        reset = (fn > self.safeguard * prev_fn) | newly_engaged
        count = jnp.where(reset, 0, count)

        slot = count % k
        Xb = Xb.at[slot].set(st.x)
        Fb = Fb.at[slot].set(f)
        count = count + 1

        filled = (jnp.arange(k) < count)
        # Gram system with unfilled slots masked out by a large diagonal.
        # Scale the Gram to unit trace (alpha is invariant to scalar
        # scaling) and regularize relative to dtype precision: in f32 the
        # raw Gram of near-parallel residuals is numerically singular and
        # un-regularized AA diverges.
        M = jnp.matmul(Fb, Fb.T, precision=_hi)
        tr = jnp.maximum(jnp.trace(M), jnp.asarray(1e-30, st.x.dtype))
        M = M / tr
        reg = jnp.maximum(jnp.asarray(self.reg, st.x.dtype),
                          100.0 * jnp.finfo(st.x.dtype).eps)
        big = jnp.asarray(1e30, st.x.dtype)
        M = M + reg * jnp.eye(k, dtype=st.x.dtype)
        M = M + jnp.where(filled, 0.0, big) * jnp.eye(k, dtype=st.x.dtype)
        ones = jnp.ones(k, st.x.dtype)
        w = jnp.linalg.solve(M, ones)
        alpha = w / jnp.sum(w)
        x_aa = jnp.matmul(alpha, Xb + Fb, precision=_hi)

        # use AA once engaged, with >= 2 pairs, and the solve stayed finite
        use_aa = engaged & (count >= 2) & jnp.all(jnp.isfinite(x_aa))
        x_new = jnp.where(use_aa, x_aa, x_plain)

        return st2._replace(
            x=x_new, aux=(st2.aux, Xb, Fb, count, fn, fnbuf, engaged, tstep))

    def getsol(self, sets, st):
        inner_aux = st.aux[0]
        st_inner = st._replace(aux=inner_aux)
        guess, st_inner = self.alg.getsol(sets, st_inner)
        return guess, st_inner._replace(aux=(st_inner.aux, *st.aux[1:]))


@dataclass(frozen=True)
class LongstepWrapper(Algorithm):
    """During the ``nsave+1`` iterations before each ``longinterval``
    boundary, record the supporting hyperplanes of every projection; at the
    boundary replace x with its projection onto their intersection
    (longstep.jl:43-60)."""

    alg: Algorithm = None
    longinterval: int = 100
    nsave: int = 10
    qp_iters: int = 400
    options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not self.alg.support_longstep:
            raise ValueError(
                f"Algorithm {type(self.alg).__name__} does not support longstep")

    def init_aux(self, x0):
        rows = 2 * (self.nsave + 1)
        planes = PlaneBuf(
            A=jnp.zeros((rows, x0.shape[0]), x0.dtype),
            b=jnp.zeros(rows, x0.dtype),
            slot=jnp.asarray(-1, jnp.int32),
        )
        return (self.alg.init_aux(x0), planes)

    def coeffs(self, aux):
        return self.alg.coeffs(aux[0])

    def step(self, sets, st: SolverState) -> SolverState:
        inner_aux, planes = st.aux
        i1 = st.i + 1  # 1-based iteration about to run
        # savepos = (i-1)%longinterval - longinterval + nsave + 2 (1-based;
        # longstep.jl:46); slot = savepos-1 in 0-based terms.
        slot = (i1 - 1) % self.longinterval - self.longinterval + self.nsave + 1
        planes = planes._replace(slot=slot.astype(jnp.int32))

        st_inner = st._replace(aux=inner_aux)
        st_inner, planes = self.alg.step_capture(sets, st_inner, planes)

        def do_longstep(args):
            x, planes = args
            y = _project_on_planes(x, planes.A, planes.b, self.nsave, self.qp_iters)
            return y

        def no_longstep(args):
            x, _ = args
            return x

        x_new = jax.lax.cond(
            slot == self.nsave, do_longstep, no_longstep, (st_inner.x, planes))
        return st_inner._replace(x=x_new, aux=(st_inner.aux, planes))

    def getsol(self, sets, st):
        inner_aux, planes = st.aux
        st_inner = st._replace(aux=inner_aux)
        guess, st_inner = self.alg.getsol(sets, st_inner)
        return guess, st_inner._replace(aux=(st_inner.aux, planes))
