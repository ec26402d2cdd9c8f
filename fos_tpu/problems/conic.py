"""Conic problem container.

``min c'x  s.t.  Ax + s = b, s in K1, x in K2`` — the MathProgBase conic
form the reference loads in ``loadproblem!``
(/root/reference/src/FOSSolverInterface.jl:31-64).  ``K1``/``K2`` are static
:class:`ConeSpec` metadata; ``A`` may be dense or BCOO sparse.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from fos_tpu.cones.spec import ConeSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConicProblem:
    A: jax.Array
    b: jax.Array
    c: jax.Array
    K1: ConeSpec = dataclasses.field(metadata=dict(static=True))
    K2: ConeSpec = dataclasses.field(metadata=dict(static=True))

    def __post_init__(self):
        m, n = self.A.shape
        if self.b.shape != (m,):
            raise ValueError(f"b must have shape ({m},), got {self.b.shape}")
        if self.c.shape != (n,):
            raise ValueError(f"c must have shape ({n},), got {self.c.shape}")
        if self.K1.dim != m:
            raise ValueError(f"K1 must cover {m} rows, covers {self.K1.dim}")
        if self.K2.dim != n:
            raise ValueError(f"K2 must cover {n} variables, covers {self.K2.dim}")

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]


def conic_problem(A, b, c, K1: ConeSpec, K2: ConeSpec) -> ConicProblem:
    try:
        import scipy.sparse as _sp

        if _sp.issparse(A):
            from jax.experimental.sparse import BCOO

            A = BCOO.from_scipy_sparse(A)
    except ImportError:
        pass
    A = A if hasattr(A, "todense") else jnp.asarray(A)
    return ConicProblem(A=A, b=jnp.asarray(b), c=jnp.asarray(c), K1=K1, K2=K2)
