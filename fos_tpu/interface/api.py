"""Public solver API.

Replaces the reference's MathProgBase plumbing
(/root/reference/src/FOSSolverInterface.jl): problems are stated directly
as ``(A, b, c, K1, K2)`` conic data (or a :class:`Feasibility` problem) and
solved with an algorithm config.

    sol = solve(A, b, c, K1=zero(m), K2=nonneg(n), alg=DR(), eps=1e-8)

Options (max_iters / eps / checki / verbose / debug / initx) follow the
reference defaults (solverwrapper.jl:4-10); kwargs passed to ``solve``
override options stored on the algorithm (Feasibility.jl:33-36).
"""

from __future__ import annotations

import time

import jax.numpy as jnp

from fos_tpu.cones.spec import ConeSpec
from fos_tpu.problems.conic import ConicProblem, conic_problem
from fos_tpu.problems.hsde import HSDEForm, Solution, populate_solution
from fos_tpu.solvers import engine
from fos_tpu.solvers.base import DR


def solve_feasibility(problem, alg=None, initx=None, **options):
    """Solve ``find x in S1 ∩ S2`` (reference: Feasibility.jl:51-55).

    kwargs here override options stored on the algorithm
    (Feasibility.jl:33-36: "kwargs in solve! overrides").
    """
    from fos_tpu.problems.feasibility import (
        Feasibility, FeasibilityForm, populate_feasibility_solution)

    t0 = time.time()
    assert isinstance(problem, Feasibility)
    if alg is None:
        alg = DR()
    opts = dict(alg.options)
    opts.update(options)
    form = FeasibilityForm.build(problem)
    init_duration = time.time() - t0
    if initx is not None:
        initx = jnp.asarray(initx, dtype=form.dtype)
    res = engine.run(form, alg, initx=initx, init_duration=init_duration, **opts)
    return populate_feasibility_solution(form, res.guess, res.status, res.iters,
                                         res.history)


def solve(A=None, b=None, c=None, K1: ConeSpec = None, K2: ConeSpec = None,
          alg=None, problem: ConicProblem = None, initx=None, dtype=None,
          warm_start: Solution = None, **options) -> Solution:
    """Solve ``min c'x s.t. Ax + s = b, s in K1, x in K2`` via the HSDE.

    ``dtype`` casts the problem data (e.g. ``jnp.float32`` for the f32
    path; defaults to the dtype of the inputs / x64 setting).

    Sparse ``A`` (scipy.sparse / BCOO) options: ``densify`` (True /
    False / "auto" — auto densifies on an accelerator when the dense form
    fits a quarter of its memory and no tile format applies; explicit tile
    formats and operator inputs are never densified) and ``sparse_format``
    ("auto" | "bcoo" | "bell" | "band" — "bell" is the blocked-ELL tile
    operator, "band" the contiguous-window variant for banded patterns;
    both f32-only; see ``HSDEForm.build`` for the auto rule).

    ``warm_start`` seeds the iteration from a previous :class:`Solution` of
    the same/nearby problem (parametric sweeps): sugar for
    ``initx=prev.raw_z`` — the reference's ``initx`` option
    (solverwrapper.jl:10) composed across solves.  Use the same
    ``equilibrate`` setting as the previous solve (``raw_z`` lives in the
    scaled iterate space).
    """
    t0 = time.time()
    if warm_start is not None:
        if initx is not None:
            raise ValueError("pass either warm_start or initx, not both")
        if warm_start.raw_z is None:
            raise ValueError(
                "warm_start solution carries no raw_z iterate (certificate "
                "or feasibility solutions cannot seed a conic solve)")
        initx = warm_start.raw_z
    raw_inputs = (A, b, c, K1, K2)
    if problem is None:
        if dtype is not None:
            A = A.astype(dtype) if hasattr(A, "astype") else jnp.asarray(A, dtype)
            b = jnp.asarray(b, dtype)
            c = jnp.asarray(c, dtype)
        problem = conic_problem(A, b, c, K1, K2)
    if alg is None:
        alg = DR()
    opts = dict(alg.options)
    opts.update(options)
    refine = int(opts.pop("refine", 0))
    refine_kwargs = dict(opts.pop("refine_kwargs", ()) or ())
    equilibrate = bool(opts.pop("equilibrate", False))
    equilibrate_iters = int(opts.pop("equilibrate_iters", 10))
    form = HSDEForm.build(
        problem,
        direct=getattr(alg, "direct", False),
        cg_max_iters=int(opts.pop("cg_max_iters", 1000)),
        cg_tol_floor=opts.pop("cg_tol_floor", None),
        psd_method=str(opts.pop("psd_method", "auto")),
        cg_variant=str(opts.pop("cg_variant", "standard")),
        cg_unroll=int(opts.pop("cg_unroll", 2)),
        equilibrate=equilibrate,
        equilibrate_iters=equilibrate_iters,
        strict_certificates=bool(opts.pop("strict_certificates", False)),
        densify=opts.pop("densify", "auto"),
        compensated=opts.pop("compensated", "auto"),
        sparse_format=opts.pop("sparse_format", "auto"),
    )
    init_duration = time.time() - t0
    if initx is not None:
        initx = jnp.asarray(initx, dtype=form.dtype)
    res = engine.run(form, alg, initx=initx, init_duration=init_duration, **opts)
    if refine > 0 and res.status in (engine.Status.CONTINUE, engine.Status.OPTIMAL):
        return _refine_solution(raw_inputs, problem, alg, form, res, refine,
                                refine_kwargs, opts, equilibrate,
                                equilibrate_iters)
    return populate_solution(form, res.guess, res.status, res.iters, res.history,
                             raw_z=res.state.x)


def _refine_solution(raw_inputs, problem, alg, form, res, refine, refine_kwargs,
                     opts, equilibrate=False, equilibrate_iters=10):
    """Post-solve f64 refinement sweep: continue the iteration at f64 from
    the f32 solution's raw iterate.

    The f32 path bottoms out at the f32 storage floor (~6e-8 relative on
    the iterate even with compensated reductions); a warm-started f64 sweep
    removes it in a few hundred iterations because the start point is
    already residual ~1e-5.  This is the f32 path's answer to the
    reference's all-f64 operating points (testDRandGAPA.jl:44-49, eps down
    to 1e-9).

    ``form64`` is rebuilt with the SAME ``equilibrate`` setting as the f32
    solve: the warm-start iterate ``res.state.x`` lives in the Ruiz-scaled
    coordinate space, and Ruiz is deterministic in (A, b, c), so the f64
    rebuild lands in (fp-identical) scaled coordinates.  Rebuilding from the
    unscaled data would seed the f64 sweep in the wrong coordinates and
    stall it.
    """
    import jax

    if not jax.config.jax_enable_x64:
        raise ValueError(
            "refine requires x64 (set FOS_TPU_X64=1 / jax_enable_x64) so the "
            "refinement sweep can run at f64")
    A, b, c, K1, K2 = raw_inputs
    if A is None:  # solve(problem=...) form: refine from the problem's data
        A, b, c, K1, K2 = problem.A, problem.b, problem.c, problem.K1, problem.K2
    prob64 = conic_problem(
        A.astype(jnp.float64) if hasattr(A, "astype") else jnp.asarray(A, jnp.float64),
        jnp.asarray(b, jnp.float64), jnp.asarray(c, jnp.float64), K1, K2)
    rk = dict(refine_kwargs)
    form64 = HSDEForm.build(
        prob64,
        direct=getattr(alg, "direct", False),
        cg_max_iters=int(rk.pop("cg_max_iters", 1000)),
        psd_method=str(rk.pop("psd_method", "auto")),
        compensated=False,
        equilibrate=equilibrate,
        equilibrate_iters=equilibrate_iters,
    )
    run_opts = {k: v for k, v in opts.items()
                if k in ("eps", "checki", "verbose", "debug")}
    run_opts.update(rk)
    run_opts["max_iters"] = refine
    # Warm start from the final raw iterate (not the projected guess): the
    # iterate is the DR/GAP fixed-point object; initx plays the reference's
    # warm-start role (solverwrapper.jl:10).
    initx = jnp.asarray(res.state.x, jnp.float64)
    res64 = engine.run(form64, alg, initx=initx, **run_opts)
    sol = populate_solution(form64, res64.guess, res64.status,
                            res.iters + res64.iters, res64.history,
                            raw_z=res64.state.x)
    return sol
