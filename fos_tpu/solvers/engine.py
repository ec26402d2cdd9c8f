"""Iteration engine.

Reference counterpart: ``solve!``/``iterate`` (src/solverwrapper.jl:2-41) —
option defaults, the hot loop, status-gated early exit, the final
``getsol`` and a forced convergence check if the loop exited unchecked.

Device-resident shape: the inner ``checki`` iterations run as one jitted
``lax.fori_loop`` chunk ending in an on-device residual check — no host
synchronization between convergence checks (SURVEY.md §7 "check-interval
control flow").  The Python-level chunk loop provides the observability
channel (status table, history) exactly where the reference prints its rows.

A fully-fused single-``while_loop`` variant for batched / sharded solves
lives in :func:`solve_fused`.
"""

from __future__ import annotations

import functools
import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from fos_tpu.solvers.base import init_solver_state, SolverState
from fos_tpu.solvers.status import Status


DEFAULT_OPTIONS = dict(max_iters=10000, verbose=1, debug=1, eps=1e-5, checki=100)
"""Reference defaults (solverwrapper.jl:4-9)."""

EXTRA_OPTIONS = frozenset({"check_finite", "profile_dir", "unroll"})
"""Documented non-reference run options (see :func:`run`)."""

# Options consumed by the form/solve layer before reaching run(); accepted
# here so algorithm-stored options (alg.options) can carry them through.
FORM_OPTIONS = frozenset({
    "cg_max_iters", "cg_tol_floor", "cg_variant", "cg_unroll",
    "psd_method",
    "equilibrate", "equilibrate_iters", "strict_certificates", "densify",
    "refine", "refine_kwargs", "compensated", "sparse_format",
})


def validate_options(options):
    """Raise on misspelled option names (e.g. 'epsilon', 'max_iter') instead
    of silently solving at the defaults."""
    allowed = set(DEFAULT_OPTIONS) | EXTRA_OPTIONS | FORM_OPTIONS
    unknown = set(options) - allowed
    if unknown:
        raise TypeError(
            f"unknown solver option(s) {sorted(unknown)}; "
            f"valid options: {sorted(allowed)}")


def _refresh_s1(sets, st: SolverState) -> SolverState:
    """Chunk-boundary re-anchor of tracked projector invariants (the HSDE
    S1 projector's v_warm = Q warm; see HSDEAffineProjector.refresh_state).
    One amortized matvec per checki iterations; no-op for other sets."""
    if hasattr(sets.s1, "refresh_state"):
        return st._replace(s1_state=sets.s1.refresh_state(st.s1_state))
    return st


@functools.partial(jax.jit, static_argnames=("alg", "nsteps", "eps", "unroll"))
def _run_chunk(alg, form, st: SolverState, nsteps: int, eps: float,
               unroll: int = 1):
    def body(_, st):
        return alg.step(form.sets, st)

    st = jax.lax.fori_loop(0, nsteps, body, st, unroll=unroll)
    st = _refresh_s1(form.sets, st)
    chk = form.check(st.z_check, eps, prev=st.z_check_prev)
    return st, chk


@functools.partial(jax.jit, static_argnames=("alg", "nsteps", "eps", "unroll"))
def _run_chunk_logged(alg, form, st: SolverState, nsteps: int, eps: float,
                      unroll: int = 1):
    """Chunk variant for logextra parity: the LAST iteration of the chunk is
    the check iteration (i % checki == 0 in the reference), so it runs as
    ``step_logged`` and its S1-stage snapshots ride back with the check."""
    def body(_, st):
        return alg.step(form.sets, st)

    st = jax.lax.fori_loop(0, nsteps - 1, body, st, unroll=unroll)
    st, snaps = alg.step_logged(form.sets, st)
    st = _refresh_s1(form.sets, st)
    chk = form.check(st.z_check, eps, prev=st.z_check_prev)
    return st, chk, snaps


@functools.partial(jax.jit, static_argnames=("alg", "nsteps"))
def _run_steps(alg, form, st: SolverState, nsteps: int):
    def body(_, st):
        return alg.step(form.sets, st)

    return jax.lax.fori_loop(0, nsteps, body, st)


@functools.partial(jax.jit, static_argnames=("alg", "eps"))
def _final_check(alg, form, st: SolverState, eps: float):
    guess, st = alg.getsol(form.sets, st)
    chk = form.check(guess, eps, prev=st.z_check)
    return guess, st, chk


@functools.partial(jax.jit, static_argnames=("alg",))
def _getsol(alg, form, st: SolverState):
    return alg.getsol(form.sets, st)


class FusedResult(NamedTuple):
    """Result of a fully-on-device solve (vmappable / shardable)."""

    guess: jnp.ndarray
    status: jnp.ndarray      # int32
    iters: jnp.ndarray       # int32
    check: Any               # final form-check scalars
    state: SolverState
    hist: jnp.ndarray        # (max_checks, nfields) residual history (or ())


def fused_solve(alg, form, x0, *, max_iters: int = 10000, eps: float = 1e-5,
                checki: int = 100, record_history: bool = False,
                unroll: int = 1, resume_state: SolverState = None,
                budget_iters: int = None) -> FusedResult:
    """Entire solve as one ``lax.while_loop`` over check-interval chunks —
    zero host synchronization, suitable for ``vmap`` over problem batches and
    ``pjit``/sharding over a device mesh.

    Once an instance's status leaves :Continue its state freezes, so batched
    (vmapped) solves keep well-defined per-instance results while the lifted
    while_loop runs until every instance terminates.  History rows are only
    written while the instance is still continuing, so a frozen instance's
    history stops at its termination row instead of repeating final values.

    The trailing ``max_iters % checki`` iterations run as one partial chunk
    after the full-chunk loop (the reference runs all max_iters,
    solverwrapper.jl:20-41), followed by the forced final check on the
    solution guess (solverwrapper.jl:32-34).

    Gap-stall recovery runs ON DEVICE here (the chunked engine's host-side
    form rebuild can't happen inside the while_loop): the CG tolerance
    floor travels as a traced ``CGState.floor`` scalar, and three
    consecutive stalled checks (``form.gap_stalled_traced``) tighten it to
    ``sqrt(2l)*eps`` — per instance under ``vmap``.
    """
    from fos_tpu.linalg.cg import CGState

    nchunks, rem = divmod(max_iters, checki)
    total_chunks = nchunks + (1 if rem else 0)
    if resume_state is not None:
        # Resumed segment (``resume_state``: a prior FusedResult.state, e.g.
        # from solve_batched(segment_iters=...)): the FULL state carries
        # over — iteration counter (the decreasing-accuracy CG schedule
        # must not restart loose: measured, an x-only restart stalls the
        # dual residual at ~1e-4), CG warm start, recovery floor, and
        # algorithm auxiliaries — so the trajectory continues exactly.
        st0 = resume_state
        x0 = st0.x
        floors = (form.fused_cg_floors()
                  if hasattr(form, "fused_cg_floors") else None)
        recovery = (floors is not None and isinstance(st0.s1_state, CGState)
                    and hasattr(form, "gap_stalled_traced"))
        if recovery:
            _, tight_floor = floors
    else:
        st0 = init_solver_state(alg, form.sets, x0)
        floors = (form.fused_cg_floors()
                  if hasattr(form, "fused_cg_floors") else None)
        recovery = (floors is not None and isinstance(st0.s1_state, CGState)
                    and hasattr(form, "gap_stalled_traced"))
        if recovery:
            default_floor, tight_floor = floors
            st0 = st0._replace(s1_state=st0.s1_state._replace(
                floor=jnp.asarray(default_floor, x0.dtype),
                win_score=jnp.asarray(jnp.inf, x0.dtype)))
    # total budget for the plateau recovery's "can it still converge at
    # this rate" test: for a resumed segment the OVERALL budget (pass it
    # via budget_iters, e.g. solve_batched(segment_iters=) does); default
    # = this call's own horizon
    if budget_iters is None:
        budget_iters = max_iters
        if resume_state is not None:
            try:  # concrete resume: extend by the iterations already done
                budget_iters = max_iters + int(resume_state.i)
            except (jax.errors.ConcretizationTypeError, TypeError):
                pass  # traced resume (vmap): pass budget_iters explicitly
    chk0 = form.check(st0.z_check, eps, prev=st0.z_check_prev)
    nhist = len(tuple(chk0))
    hist0 = jnp.zeros((total_chunks, nhist), x0.dtype) if record_history else jnp.zeros((0, 0), x0.dtype)

    def body(_, s):
        return alg.step(form.sets, s)

    plateau = (recovery and hasattr(form, "plateau_stalled_traced")
               and getattr(st0.s1_state, "win_score", None) is not None)
    W = getattr(form, "STALL_WINDOW", 10)

    def run_chunk(st, status, k, hist, stall, nsteps):
        """One nsteps-iteration chunk + check, masked by the freeze flag."""
        st_new = jax.lax.fori_loop(0, nsteps, body, st, unroll=unroll)
        st_new = _refresh_s1(form.sets, st_new)
        chk = form.check(st_new.z_check, eps, prev=st_new.z_check_prev)
        # freeze once terminated (matters under vmap)
        cont = status == Status.CONTINUE
        if record_history:
            row = jnp.stack([v.astype(x0.dtype) for v in tuple(chk)])
            hist = hist.at[k].set(jnp.where(cont, row, hist[k]))
        st = jax.tree_util.tree_map(
            lambda new, old: jnp.where(cont, new, old), st_new, st)
        status = jnp.where(cont, chk.status, status)
        if recovery:
            # original gap-only signature: 3 consecutive checks
            gap_now = cont & form.gap_stalled_traced(chk, eps)
            stall = jnp.where(gap_now, stall + 1, jnp.zeros_like(stall))
            fire = stall >= 3
            if plateau:
                # budget-aware plateau (round 4): once per W checks, fire
                # when the measured improvement rate cannot reach the
                # operating point within the remaining budget — catches
                # floor-limited d-stalls (the batched SDP) without
                # derailing slow-but-converging runs.  Anchored on the
                # TRUE iteration counter st.i and the state-carried
                # baseline so segmented solves (resume_state) keep the
                # window across segments.
                ck = (st.i // checki).astype(jnp.int32)
                at_win = (ck % W) == 0
                remaining = jnp.maximum(
                    jnp.asarray(budget_iters, jnp.int32) // checki - ck, 1)
                p_stalled, score = form.plateau_stalled_traced(
                    chk, eps, st.s1_state.win_score, remaining)
                fire = fire | (cont & at_win & p_stalled)
                new_win = jnp.where(cont & at_win, score,
                                    st.s1_state.win_score)
                st = st._replace(
                    s1_state=st.s1_state._replace(win_score=new_win))
            cur = st.s1_state.floor
            newf = jnp.where(fire & (cur > tight_floor),
                             jnp.asarray(tight_floor, cur.dtype), cur)
            st = st._replace(s1_state=st.s1_state._replace(floor=newf))
        return st, status, hist, stall

    def chunk_body(carry):
        st, status, k, hist, stall = carry
        st, status, hist, stall = run_chunk(st, status, k, hist, stall,
                                            checki)
        return st, status, k + 1, hist, stall

    def chunk_cond(carry):
        _, status, k, _, _ = carry
        return (status == Status.CONTINUE) & (k < nchunks)

    st, status, k, hist, stall = jax.lax.while_loop(
        chunk_cond, chunk_body,
        (st0, jnp.asarray(Status.CONTINUE, jnp.int32),
         jnp.asarray(0, jnp.int32), hist0, jnp.asarray(0, jnp.int32)),
    )
    if rem:
        # exact budget: the trailing max_iters % checki iterations (masked
        # out per-instance if already terminated)
        st, status, hist, stall = run_chunk(st, status, nchunks, hist, stall,
                                            rem)
    # NOTE: getsol runs one extra S1 projection for the solution guess; its
    # mutated CG state (warm start overwritten, call_idx bumped) must NOT
    # leak into FusedResult.state, or a resumed segment's first projection
    # diverges from the unsegmented trajectory (code-review finding, r4)
    guess, _ = alg.getsol(form.sets, st)
    chk = form.check(guess, eps, prev=st.z_check)
    status = jnp.where(status == Status.CONTINUE, chk.status, status)
    return FusedResult(guess=guess, status=status, iters=st.i, check=chk, state=st,
                       hist=hist)


class RunResult(NamedTuple):
    guess: jnp.ndarray
    status: int
    iters: int
    history: Any
    state: SolverState


def run(form, alg, *, initx=None, init_duration: float = 0.0,
        resume_state: SolverState = None, **options) -> RunResult:
    """Chunked solve with reference-equivalent check/print/exit semantics.

    Extra (non-reference) options: ``resume_state`` resumes from a
    checkpointed :class:`SolverState` (utils/checkpoint.py);
    ``check_finite`` raises FloatingPointError when a convergence check
    turns non-finite (the NaN-debugging tier of SURVEY.md §5);
    ``profile_dir`` wraps the iteration loop in a ``jax.profiler`` trace.
    """
    validate_options(options)
    opts = dict(DEFAULT_OPTIONS)
    opts.update(options)
    max_iters = int(opts["max_iters"])
    checki = int(opts["checki"])
    eps = float(opts["eps"])
    verbose = int(opts["verbose"])
    debug = int(opts["debug"])
    check_finite = bool(opts.get("check_finite", False))
    profile_dir = opts.get("profile_dir", None)
    # iterations per compiled loop step: amortizes the fixed device-loop
    # cost per step; 1 = reference-equivalent default
    unroll = int(opts.get("unroll", 1))

    if resume_state is not None:
        st = resume_state
    else:
        x0 = initx if initx is not None else form.initial_value(form.dtype)
        st = init_solver_state(alg, form.sets, x0)
    if profile_dir:
        import jax.profiler

        jax.profiler.start_trace(profile_dir)

    from fos_tpu.utils.history import History

    hist = History() if debug > 0 else None
    if verbose > 0:
        print(form.header(init_duration))
    t_iter0 = time.time()
    t_init = time.time()

    status_code = Status.CONTINUE
    # Resumed runs report cumulative iteration counts: st.i carries the true
    # total, so history indices and Solution.iters continue where the
    # checkpoint left off (a fresh max_iters budget still applies).
    i = int(st.i) if resume_state is not None else 0
    i_start = i  # plateau budget anchor: a fresh max_iters applies from here
    checked = False
    # logextra parity: feasibility-form runs at debug>0 record the S1-stage
    # snapshot triple at every check iteration (FeasibilityStatus.jl:19-25)
    log_extra = debug > 0 and getattr(form, "wants_extra", False)
    # stall recovery: the CG floor is biasing the fixed point when the
    # p/d-pass-gap-fail signature holds for 3 consecutive checks, OR when
    # the budget-aware plateau test says the measured improvement rate
    # cannot reach the operating point in the remaining budget (evaluated
    # once per STALL_WINDOW checks) — tighten the floor once and continue
    # (HSDEForm.gap_stalled/plateau_stalled/tighten_cg)
    stall_count = 0
    tightened = False
    win_score = float("inf")
    ncheck = 0
    W = getattr(form, "STALL_WINDOW", 10)
    nchunks, rem = divmod(max_iters, checki)
    for _ in range(nchunks):
        if log_extra:
            st, chk, snaps = _run_chunk_logged(alg, form, st, checki, eps,
                                               unroll)
        else:
            st, chk = _run_chunk(alg, form, st, checki, eps, unroll)
            snaps = None
        i += checki
        checked = True
        status_code = int(chk.status)
        ncheck += 1
        if (not tightened and status_code == Status.CONTINUE
                and hasattr(form, "gap_stalled")):
            fire = False
            if form.gap_stalled(chk, eps):
                stall_count += 1
                fire = stall_count >= 3
            else:
                stall_count = 0
            if (not fire and hasattr(form, "plateau_stalled")
                    and ncheck % W == 0):
                # budget is max_iters FRESH iterations from i_start (resumed
                # runs would otherwise see remaining=1 immediately and fire
                # the recovery prematurely — code-review finding, r4)
                remaining = max((i_start + max_iters - i) // checki, 1)
                p_stalled, score = form.plateau_stalled(chk, eps, win_score,
                                                        remaining)
                win_score = score
                fire = p_stalled
            if fire:
                new_form = form.tighten_cg()
                tightened = True
                if new_form is not None:
                    form = new_form
                    if verbose > 0:
                        print(f"Residual progress stalled at i={i}: "
                              f"tightening CG tolerance floor")
        else:
            stall_count = 0
        t_elapsed = time.time() - t_init
        form.record(hist, st, chk, i, t_elapsed, debug, extra=snaps)
        if verbose > 0:
            print(form.row(st, chk, i, t_elapsed))
            if status_code == Status.OPTIMAL:
                print(f"Found solution i={i}")
        if check_finite:
            import numpy as _np

            vals = [float(v) for v in tuple(chk)[1:]]
            if not all(_np.isfinite(v) for v in vals):
                if profile_dir:
                    import jax.profiler

                    jax.profiler.stop_trace()
                raise FloatingPointError(
                    f"non-finite convergence-check values at iteration {i}: "
                    f"{dict(zip(chk._fields[1:], vals))}")
        if status_code != Status.CONTINUE:
            break
    else:
        if rem > 0:
            st = _run_steps(alg, form, st, rem)
            i += rem
            checked = False

    if status_code != Status.CONTINUE or checked:
        guess, st = _getsol(alg, form, st)
    else:
        # Loop exited without a check at the final iteration: force one on the
        # solution guess (solverwrapper.jl:32-34, override=true).
        guess, st, chk = _final_check(alg, form, st, eps)
        status_code = int(chk.status)
        t_elapsed = time.time() - t_init
        form.record(hist, st, chk, i, t_elapsed, debug, extra=None)
        if verbose > 0:
            print(form.row(st, chk, i, t_elapsed))
            if status_code == Status.OPTIMAL:
                print(f"Found solution i={i}")

    if profile_dir:
        import jax.profiler

        jax.block_until_ready(guess)
        jax.profiler.stop_trace()
    if verbose > 0:
        print("Time for iterations: ")
        print(f"{time.time() - t_iter0} s")
    return RunResult(guess=guess, status=status_code, iters=i, history=hist, state=st)
