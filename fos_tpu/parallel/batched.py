"""Batched solving of independent problem instances.

The reference is strictly single-problem/single-thread; batching is the
first parallelism axis (SURVEY.md §2c "Data parallel"): stack B
instances that share shapes and cone structure, vmap the fused solver over
the stack, and (optionally) shard the batch axis across the device mesh.
Per-instance termination is handled inside :func:`fused_solve` by freezing
terminated instances, so the lifted while_loop runs until the slowest
instance finishes without corrupting the others.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fos_tpu.cones.spec import ConeSpec
from fos_tpu.problems.hsde import HSDEForm, hsde_cone_spec
from fos_tpu.linalg.affine import HSDEAffineProjector
from fos_tpu.solvers.base import ConeSet, TwoSets
from fos_tpu.solvers.engine import FusedResult, fused_solve


def build_batched_form(A, b, c, K1: ConeSpec, K2: ConeSpec, *, direct=False,
                       cg_max_iters: int = 1000) -> HSDEForm:
    """A: (B, m, n), b: (B, m), c: (B, n) — one HSDEForm pytree with a
    leading batch axis on every array leaf."""
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    c = jnp.asarray(c)
    B, m, n = A.shape
    if K1.dim != m or K2.dim != n:
        raise ValueError("cone specs must cover (m, n)")
    if direct:
        # batched QR least-squares maps (B, 2l, l) — same construction as
        # HSDEAffineProjector.create (QR touches the conditioning once; a
        # Cholesky of I + Q'Q squares sigma_max, see linalg/affine.py);
        # host f64 LAPACK per instance when concrete (_ls_projection_fac)
        from fos_tpu.linalg import hsde_ops
        from fos_tpu.linalg.affine import _ls_projection_fac

        Qd = jax.vmap(hsde_ops.q_dense)(A, b, c)
        fac = _ls_projection_fac(Qd, eye_first=True)
        s1 = HSDEAffineProjector(A, b, c, fac, direct=True,
                                 decreasing_accuracy=False,
                                 cg_max_iters=cg_max_iters)
    else:
        s1 = HSDEAffineProjector(A, b, c, None, direct=False,
                                 decreasing_accuracy=True,
                                 cg_max_iters=cg_max_iters)
    s2 = ConeSet(hsde_cone_spec(K1, K2))
    norm_b = jnp.linalg.norm(b, axis=-1)
    norm_c = jnp.linalg.norm(c, axis=-1)
    # compensated convergence-check reductions for f32 batches, matching
    # the single-problem build (problems/hsde.py)
    comp = jnp.dtype(b.dtype) == jnp.float32
    return HSDEForm(TwoSets(s1, s2), A, b, c, norm_b, norm_c, n, m,
                    compensated=comp)


@functools.partial(jax.jit, static_argnames=("alg", "max_iters", "eps", "checki",
                                             "record_history", "unroll",
                                             "budget_iters"))
def _solve_batched_once(alg, form: HSDEForm, *, max_iters, eps, checki,
                        record_history, unroll, initx,
                        resume_state=None, budget_iters=None) -> FusedResult:
    B = form.b.shape[0]
    l = form.n + form.m + 1
    if initx is not None:
        x0 = jnp.asarray(initx, form.b.dtype)
        if x0.shape != (B, 2 * l):
            raise ValueError(f"initx must be (B, 2l) = {(B, 2 * l)}, "
                             f"got {x0.shape}")
    else:
        x0 = (
            jnp.zeros((B, 2 * l), form.b.dtype)
            .at[:, l - 1].set(1.0)
            .at[:, 2 * l - 1].set(1.0)
        )

    if resume_state is not None:
        def one(form_i, x0_i, st_i):
            return fused_solve(alg, form_i, x0_i, max_iters=max_iters,
                               eps=eps, checki=checki,
                               record_history=record_history, unroll=unroll,
                               resume_state=st_i, budget_iters=budget_iters)

        return jax.vmap(one)(form, x0, resume_state)

    def one0(form_i, x0_i):
        return fused_solve(alg, form_i, x0_i, max_iters=max_iters, eps=eps,
                           checki=checki, record_history=record_history,
                           unroll=unroll, budget_iters=budget_iters)

    return jax.vmap(one0)(form, x0)


def solve_batched(alg, form: HSDEForm, *, max_iters: int = 10000,
                  eps: float = 1e-5, checki: int = 100,
                  record_history: bool = False, unroll: int = 1,
                  initx=None, segment_iters: int = None) -> FusedResult:
    """vmap the fused solver over the leading batch axis of ``form``.

    ``initx``: optional ``(B, 2l)`` warm-start iterates (e.g. a previous
    batch's ``result.state.x`` for parametric sweeps — the batched twin of
    ``solve(..., warm_start=prev)``).

    ``segment_iters``: split the budget into host-resumed fused segments
    of at most this many iterations each (e.g. to report progress or
    checkpoint between segments of a long batched solve).  Each segment
    resumes from the previous segment's FULL solver
    state (``FusedResult.state``), so the trajectory — the iterates, the
    decreasing-accuracy CG schedule, warm starts, and the recovery state —
    continues through segment boundaries like one long run's chunk
    boundaries.  NOT bit-identical in general: each segment ends with the
    engine's forced guess-check (solverwrapper.jl:32-34 semantics), which
    can terminate an instance at a boundary where the unsegmented run had
    no check — earlier, with a certificate that passed the same eps test
    (at f32 this shows as stop-point differences inside the eps band; the
    x64 regression test below observes exact equality because every
    boundary check there agrees with the chunk schedule).  Per-instance
    status is the FIRST non-Continue status observed, iteration counts
    carry in ``state.i``, and ``record_history`` chunks concatenate
    across segments (rows for instances that finished in an earlier
    segment are zeroed)."""
    if segment_iters is None or segment_iters >= max_iters:
        return _solve_batched_once(alg, form, max_iters=max_iters, eps=eps,
                                   checki=checki,
                                   record_history=record_history,
                                   unroll=unroll, initx=initx)

    merged = None
    done = None
    hists = []
    state = None
    dummy_hist = None
    remaining = max_iters
    while remaining > 0:
        seg = min(segment_iters, remaining)
        remaining -= seg
        res = _solve_batched_once(alg, form, max_iters=seg, eps=eps,
                                  checki=checki,
                                  record_history=record_history,
                                  unroll=unroll, initx=initx,
                                  resume_state=state,
                                  budget_iters=max_iters)
        if record_history:
            # lanes already terminated before this segment re-run from
            # frozen iterates (fused_solve has no per-lane status input);
            # their rows are artifacts — zero them
            h = res.hist
            if done is not None:
                h = jnp.where(done[:, None, None], 0.0, h)
            hists.append(h)
        # hist chunk counts differ when max_iters % segment_iters != 0 —
        # keep it OUT of the elementwise merge (concatenated at the end)
        if dummy_hist is None:
            dummy_hist = jnp.zeros((res.hist.shape[0], 0, 0),
                                   res.guess.dtype) if res.hist.ndim else ()
        res = res._replace(hist=dummy_hist)
        if merged is None:
            merged = res
            done = res.status != 0
        else:
            keep = done  # instances already terminated keep their result
            merged = jax.tree_util.tree_map(
                lambda old, new: jnp.where(
                    keep.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)
                if getattr(new, "ndim", 0) > 0 else old, merged, res)
            done = done | (res.status != 0)
            merged = merged._replace(
                status=jnp.where(done, merged.status, 0))
        state = merged.state
        if bool(jnp.all(done)):
            break
    # state.i carries the true cumulative count (resume keeps counting)
    merged = merged._replace(iters=merged.state.i)
    if record_history:
        merged = merged._replace(hist=jnp.concatenate(hists, axis=1))
    return merged


def form_initial_value(form: HSDEForm):
    l = form.n + form.m + 1
    z = jnp.zeros(2 * l, dtype=form.b.dtype)
    z = z.at[l - 1].set(1.0)
    z = z.at[2 * l - 1].set(1.0)
    return z
