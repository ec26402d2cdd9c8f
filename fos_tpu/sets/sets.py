"""Projectable-set library for feasibility problems.

Native replacements for the ProximalOperators sets the reference leans on
(SURVEY.md §2b): ``IndAffine`` (cached-factorization affine projection),
``IndBox``, ``IndPoint``, ``IndBallL2``, ``IndHalfspace``, plus cone sets
via :class:`fos_tpu.solvers.base.ConeSet` and arbitrary user projections.

All sets follow the solver set protocol: registered pytrees with
``init_state(dtype)`` and ``project(x, state) -> (y, state)``; stateless
sets carry ``()`` state.  Projections support leading batch dimensions so
wrappers can evaluate candidate grids in one vmapped pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fos_tpu.linalg.cg import CGState, conjugate_gradient
from fos_tpu.solvers.base import ConeSet  # noqa: F401  (re-exported)


class _StatelessSet:
    def init_state(self, dtype):
        return ()


@jax.tree_util.register_pytree_node_class
class AffineSet(_StatelessSet):
    """{x : Ax = b} — replaces ProximalOperators ``IndAffine``.

    direct mode caches ``P = A'(AA')^{-1}`` so each projection is
    ``y = x - P(Ax - b)`` (two GEMVs); indirect mode solves
    ``(AA') mu = Ax - b`` by warm-started CG.
    """

    projection_is_affine = True       # probe-cache eligible (wrappers.py)
    projection_offset_free = False    # offset b

    def __init__(self, A, b, P=None, *, direct=True, cg_max_iters=1000):
        self.A = A
        self.b = b
        self.P = P
        self.direct = direct
        self.cg_max_iters = cg_max_iters

    def tree_flatten(self):
        return (self.A, self.b, self.P), (self.direct, self.cg_max_iters)

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, b, P = children
        return cls(A, b, P, direct=aux[0], cg_max_iters=aux[1])

    @classmethod
    def create(cls, A, b, *, direct=True, cg_max_iters=1000):
        A = jnp.asarray(A) if not hasattr(A, "todense") else A
        b = jnp.asarray(b)
        P = None
        if direct:
            # QR of A' (the reference's IndAffine primitive, HSDE.jl:15):
            # P = A'(AA')^{-1} = Q R^{-T} touches cond(A) once — a
            # Cholesky/inverse of AA' squares it (measured: 9e-4 error at
            # cond(A) = 1e7 vs 1e-9 via QR, test_linalg.py).
            # P = Q R^{-T} of QR(A'); host f64 LAPACK when concrete
            # (see linalg/affine.py)
            from fos_tpu.linalg.affine import _ls_projection_fac

            Ad = A.todense() if hasattr(A, "todense") else A
            P = _ls_projection_fac(Ad.T, eye_first=None)
        return cls(A, b, P, direct=direct, cg_max_iters=cg_max_iters)

    def init_state(self, dtype):
        if self.direct:
            return ()
        return CGState.create(self.b.shape[0], dtype)

    def project(self, x, state):
        if x.ndim > 1 and not self.direct:
            # Batched candidates (GAPP grids, line-search sweeps): vmap the
            # CG solve per row; warm-start state is shared read-only.
            y, _ = jax.vmap(lambda xi: self.project(xi, state))(x)
            return y, state
        # every matvec at full f32 (no TF32): a reduced precision displaces
        # fixed points — including the RESIDUAL, not just the projection map
        from fos_tpu.linalg.hsde_ops import PREC as _hi

        resid = (jnp.matmul(x, self.A.T, precision=_hi) - self.b
                 if x.ndim > 1 else
                 jnp.matmul(self.A, x, precision=_hi) - self.b)
        if self.direct:
            y = (x - jnp.matmul(resid, self.P.T, precision=_hi)
                 if x.ndim > 1 else
                 x - jnp.matmul(self.P, resid, precision=_hi))
            return y, state
        warm = jnp.where(state.initialized, state.warm, jnp.zeros_like(resid))
        floor = self.b.shape[0] * jnp.finfo(x.dtype).eps
        res = conjugate_gradient(
            lambda mu: jnp.matmul(
                self.A, jnp.matmul(self.A.T, mu, precision=_hi),
                precision=_hi),
            resid, warm, tol=floor, max_iters=self.cg_max_iters,
        )
        y = x - jnp.matmul(self.A.T, res.x, precision=_hi)
        return y, CGState(res.x, jnp.asarray(True), state.call_idx + 1, res.iters)


@jax.tree_util.register_pytree_node_class
class Box(_StatelessSet):
    """{x : lo <= x <= hi} — ``IndBox``.  Scalars broadcast."""

    def __init__(self, lo, hi):
        self.lo = jnp.asarray(lo)
        self.hi = jnp.asarray(hi)

    def tree_flatten(self):
        return (self.lo, self.hi), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def project(self, x, state):
        return jnp.clip(x, self.lo, self.hi), state


def NonNeg():
    """{x : x >= 0} — ``IndNonnegative`` / ``IndBox(0, Inf)``."""
    return Box(0.0, jnp.inf)


def NonPos():
    return Box(-jnp.inf, 0.0)


@jax.tree_util.register_pytree_node_class
class Point(_StatelessSet):
    """{p} — ``IndPoint``."""

    def __init__(self, p):
        self.p = jnp.asarray(p)

    def tree_flatten(self):
        return (self.p,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def project(self, x, state):
        return jnp.broadcast_to(self.p, x.shape), state


@jax.tree_util.register_pytree_node_class
class Halfspace(_StatelessSet):
    """{x : <a, x> <= beta} — ``IndHalfspace``."""

    def __init__(self, a, beta):
        self.a = jnp.asarray(a)
        self.beta = jnp.asarray(beta)

    def tree_flatten(self):
        return (self.a, self.beta), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def project(self, x, state):
        from fos_tpu.linalg.hsde_ops import PREC as _hi

        # full-f32 contraction (a reduced precision distorts the violation
        # estimate for batched x)
        viol = ((jnp.matmul(x, self.a, precision=_hi) - self.beta)
                / jnp.vdot(self.a, self.a, precision=_hi))
        viol = jnp.maximum(viol, 0.0)
        return x - viol[..., None] * self.a if x.ndim > 1 else x - viol * self.a, state


@jax.tree_util.register_pytree_node_class
class Ball(_StatelessSet):
    """{x : ||x - center|| <= radius} — ``IndBallL2``."""

    def __init__(self, radius, center=None):
        self.radius = jnp.asarray(radius)
        self.center = center

    def tree_flatten(self):
        return (self.radius, self.center), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1])

    def project(self, x, state):
        d = x if self.center is None else x - self.center
        nrm = jnp.linalg.norm(d, axis=-1, keepdims=x.ndim > 1)
        scale = jnp.where(nrm > self.radius, self.radius / jnp.where(nrm > 0, nrm, 1.0), 1.0)
        y = d * scale
        return (y if self.center is None else y + self.center), state


@jax.tree_util.register_pytree_node_class
class BlockSet:
    """Product of sets over contiguous index ranges — the role of
    ProximalOperators' ``SlicedSeparableSum`` (used by the reference's Youla
    example, examples/youla.jl:198-205).

    ``BlockSet([(set1, d1), (set2, d2), ...])`` projects slice
    ``[0:d1]`` with set1, ``[d1:d1+d2]`` with set2, etc.  Stateful member
    sets (e.g. CG-backed AffineSet) carry their state in a tuple.
    """

    def __init__(self, blocks):
        self.sets = tuple(s for s, _ in blocks)
        self.dims = tuple(int(d) for _, d in blocks)

    def tree_flatten(self):
        return (self.sets,), (self.dims,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.sets = tuple(children[0])
        obj.dims = aux[0]
        return obj

    @property
    def dim(self):
        return sum(self.dims)

    def init_state(self, dtype):
        return tuple(s.init_state(dtype) for s in self.sets)

    def project(self, x, state):
        outs = []
        new_state = []
        off = 0
        for s, d, st in zip(self.sets, self.dims, state):
            y, st2 = s.project(x[..., off : off + d], st)
            outs.append(y)
            new_state.append(st2)
            off += d
        return jnp.concatenate(outs, axis=-1), tuple(new_state)


@jax.tree_util.register_pytree_node_class
class FunctionSet(_StatelessSet):
    """Wrap an arbitrary pure projection ``fn(x) -> y`` (closure constants
    are baked into the jit trace)."""

    def __init__(self, fn):
        self.fn = fn

    def tree_flatten(self):
        return (), (self.fn,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0])

    def project(self, x, state):
        return self.fn(x), state
