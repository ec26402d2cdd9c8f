"""fos_tpu — a first-order conic solver framework for accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``mfalt/FirstOrderSolvers.jl`` (reference at /root/reference):

* Conic programs ``min c'x  s.t.  Ax + s = b, s in K1, x in K2`` solved through
  the SCS-style homogeneous self-dual embedding (HSDE)
  (reference: src/problemforms/HSDE/HSDE.jl).
* Set-feasibility problems ``find x in S1 ∩ S2`` for arbitrary projectable
  sets (reference: src/problemforms/Feasibility/Feasibility.jl).
* The GAP algorithm family — GAP, DR, AP, GAPA, GAPP, FISTA, Dykstra — plus
  line-search and long-step wrapper combinators
  (reference: src/solvers/*, src/wrappers/*).

Design stance (NOT a port): solvers are pure ``state -> state`` functions
compiled into ``lax.while_loop``/``fori_loop`` chunks with on-device
convergence checks; cone products are single fused vectorized projection
passes; the HSDE affine projection is a warm-started CG on the SPD system
``(I + Q'Q) u = rhs`` instead of the reference's 2l x 2l indefinite KKT
system; scale-out uses ``jax.sharding`` meshes and batched (vmapped)
instances.
"""

from fos_tpu import config as config  # noqa: F401  (applies x64 default)

from fos_tpu.cones import Cone, ConeSpec, project, project_dual  # noqa: F401
from fos_tpu.solvers import (  # noqa: F401
    AP,
    DR,
    Dykstra,
    FISTA,
    GAP,
    GAPA,
    GAPP,
    AndersonWrapper,
    LineSearchWrapper,
    LongstepWrapper,
)
from fos_tpu.problems import ConicProblem, Solution, conic_problem  # noqa: F401
from fos_tpu.interface import (  # noqa: F401
    register_with_cvxpy,
    solve,
    solve_conic_data,
    solve_lp,
    solve_scs,
)
from fos_tpu.interface.api import solve_feasibility  # noqa: F401
from fos_tpu.problems.feasibility import Feasibility  # noqa: F401
from fos_tpu.diff import diff_solve  # noqa: F401
from fos_tpu.modeling import (  # noqa: F401
    ExpCone,
    PowCone,
    Problem,
    Variable,
    maximize,
    minimize,
    norm1,
    norm2,
    norm_inf,
    quad_form,
    sum_squares,
    trace,
)

__version__ = "0.1.0"
