"""Batched + sharded solve tests on the 8-device virtual CPU mesh.

SURVEY.md §4 missing-tier tests: sharded/batched paths must agree with the
single-chip chunked engine to tolerance.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fos_tpu import DR, GAPA, solve
from fos_tpu.cones import nonneg, zero
from fos_tpu.parallel import (
    build_batched_form,
    make_mesh,
    shard_batched_form,
    shard_problem_rows,
)
from fos_tpu.problems.hsde import HSDEForm
from fos_tpu.problems.conic import conic_problem
from fos_tpu.solvers.engine import fused_solve
from fos_tpu.solvers.status import Status
from fos_tpu.parallel.batched import solve_batched


def _lp_batch(rng, B=4, m=24, n=40):
    """Batch of LP instances min c'x s.t. Ax + s = b, s,x >= 0 constructed
    with primal-dual optimal certificates (complementary slackness), so each
    instance has a finite optimum and the HSDE converges with tau > 0."""
    A = rng.standard_normal((B, m, n))
    xmask = rng.random((B, n)) < 0.5
    x0 = np.abs(rng.standard_normal((B, n))) * xmask          # primal solution
    r0 = np.abs(rng.standard_normal((B, n))) * (~xmask)       # dual slack, r'x = 0
    ymask = rng.random((B, m)) < 0.5
    y0 = np.abs(rng.standard_normal((B, m))) * ymask          # dual solution
    s0 = np.abs(rng.standard_normal((B, m))) * (~ymask)       # primal slack, s'y = 0
    b = np.einsum("bmn,bn->bm", A, x0) + s0
    c = r0 - np.einsum("bmn,bm->bn", A, y0)
    return A, b, c


def test_fused_matches_chunked(rng):
    A, b, c = _lp_batch(rng, B=1)
    A, b, c = A[0], b[0], c[0]
    m, n = A.shape
    sol = solve(A, b, c, nonneg(m), nonneg(n), alg=DR(), eps=1e-7,
                max_iters=10000, verbose=0)
    prob = conic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         nonneg(m), nonneg(n))
    form = HSDEForm.build(prob)
    res = fused_solve(DR(), form, form.initial_value(form.dtype),
                      max_iters=10000, eps=1e-7, checki=100)
    assert int(res.status) == Status.OPTIMAL
    assert sol.status == "Optimal"
    tau = res.guess[form.l - 1]
    x_fused = np.asarray(res.guess[: form.n] / tau)
    np.testing.assert_allclose(x_fused, np.asarray(sol.x), atol=1e-6)
    assert int(res.iters) == sol.iters


def test_fused_resume_state_single(rng):
    """fused_solve(resume_state=prev.state) continues the trajectory
    exactly: two 700-iteration segments == one 1400-iteration run
    (iterate, iteration counter, CG schedule all carried)."""
    A, b, c = _lp_batch(rng, B=1)
    A, b, c = A[0], b[0], c[0]
    m, n = A.shape
    prob = conic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         nonneg(m), nonneg(n))
    form = HSDEForm.build(prob)
    z0 = form.initial_value(form.dtype)
    full = fused_solve(DR(), form, z0, max_iters=1400, eps=0.0, checki=100)
    r1 = fused_solve(DR(), form, z0, max_iters=700, eps=0.0, checki=100)
    r2 = fused_solve(DR(), form, z0, max_iters=700, eps=0.0, checki=100,
                     resume_state=r1.state)
    assert int(r2.state.i) == int(full.state.i) == 1400
    np.testing.assert_allclose(np.asarray(r2.state.x),
                               np.asarray(full.state.x),
                               rtol=1e-12, atol=1e-12)


def test_fused_budget_exact_and_history_gated(rng):
    """VERDICT r2 item 6: fused_solve must run the trailing
    max_iters % checki iterations (reference runs all max_iters,
    solverwrapper.jl:20-41) and must stop writing history rows once an
    instance terminates."""
    A, b, c = _lp_batch(rng, B=1)
    A, b, c = A[0], b[0], c[0]
    m, n = A.shape
    prob = conic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         nonneg(m), nonneg(n))
    form = HSDEForm.build(prob)
    # unreachable eps: both engines must spend the exact 250-iteration budget
    from fos_tpu.solvers import engine
    res_f = fused_solve(DR(), form, form.initial_value(form.dtype),
                        max_iters=250, eps=1e-30, checki=100)
    res_c = engine.run(form, DR(), max_iters=250, eps=1e-30, checki=100,
                       verbose=0)
    assert int(res_f.iters) == 250 == res_c.iters
    # history gating: rows after the termination row stay zero
    res = fused_solve(DR(), form, form.initial_value(form.dtype),
                      max_iters=10000, eps=1e-7, checki=100,
                      record_history=True)
    assert int(res.status) == Status.OPTIMAL
    kterm = int(res.iters) // 100 - 1   # 0-based chunk of the termination row
    hist = np.asarray(res.hist)
    assert np.any(hist[kterm] != 0)
    assert np.all(hist[kterm + 1:] == 0)


def test_batched_solve(rng):
    A, b, c = _lp_batch(rng, B=4)
    m, n = A.shape[1:]
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n))
    res = solve_batched(DR(), form, max_iters=10000, eps=1e-6, checki=100)
    assert res.status.shape == (4,)
    assert np.all(np.asarray(res.status) == Status.OPTIMAL)
    # each instance matches its standalone solve (objective-level agreement:
    # the vmapped CG runs more inner iterations for fast instances, so
    # trajectories differ slightly — like psum-order nondeterminism)
    for i in range(4):
        sol = solve(A[i], b[i], c[i], nonneg(m), nonneg(n), alg=DR(), eps=1e-6,
                    max_iters=10000, verbose=0)
        l = m + n + 1
        tau = res.guess[i, l - 1]
        x_b = np.asarray(res.guess[i, :n] / tau)
        obj_b = float(c[i] @ x_b)
        obj_s = float(c[i] @ np.asarray(sol.x))
        assert abs(obj_b - obj_s) <= 1e-4 * (1 + abs(obj_s))
        s_b = b[i] - A[i] @ x_b
        assert x_b.min() > -1e-5 and s_b.min() > -1e-4


def test_batched_sharded(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    A, b, c = _lp_batch(rng, B=8, m=16, n=24)
    m, n = A.shape[1:]
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n))
    res_plain = solve_batched(DR(), form, max_iters=3000, eps=1e-6, checki=100)

    mesh = make_mesh((8, 1), ("batch", "model"))
    form_sharded = shard_batched_form(form, mesh)
    res_shard = solve_batched(DR(), form_sharded, max_iters=3000, eps=1e-6, checki=100)
    np.testing.assert_array_equal(np.asarray(res_shard.status),
                                  np.asarray(res_plain.status))
    # solution-level agreement: FP-rounding differences across device
    # placement amplify through thousands of iterations, so compare
    # objectives and feasibility, not raw iterates (SURVEY.md §7)
    l = m + n + 1
    for i in range(8):
        x_p = np.asarray(res_plain.guess[i, :n] / res_plain.guess[i, l - 1])
        x_s = np.asarray(res_shard.guess[i, :n] / res_shard.guess[i, l - 1])
        obj_p, obj_s = float(c[i] @ x_p), float(c[i] @ x_s)
        assert abs(obj_p - obj_s) <= 1e-4 * (1 + abs(obj_p))
        assert x_s.min() > -1e-5
        assert (b[i] - A[i] @ x_s).min() > -1e-3


def test_row_sharded_single_problem(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    m, n = 32, 20
    A, b, c = _lp_batch(rng, B=1, m=m, n=n)
    A, b, c = A[0], b[0], c[0]
    prob = conic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         nonneg(m), nonneg(n))
    form = HSDEForm.build(prob)
    res_plain = fused_solve(DR(), form, form.initial_value(form.dtype),
                            max_iters=1500, eps=1e-6, checki=100)

    mesh = make_mesh((1, 8), ("batch", "model"))
    form_sh = shard_problem_rows(form, mesh)
    fn = jax.jit(lambda f, x0: fused_solve(DR(), f, x0, max_iters=1500, eps=1e-6,
                                           checki=100), static_argnames=())
    res_sh = fn(form_sh, form.initial_value(form.dtype))
    assert int(res_sh.status) == int(res_plain.status)
    # correctness of the sharded math: the device-computed residuals must
    # match a numpy recomputation from the sharded run's own guess
    l = m + n + 1
    g = np.asarray(res_sh.guess)
    x, y, tau = g[:n], g[n : n + m], g[l - 1]
    s = g[l + n : l + n + m]
    p_np = np.linalg.norm(A @ (x / tau) + s / tau - b) / (1 + np.linalg.norm(b))
    assert abs(p_np - float(res_sh.check.p)) < 1e-9 * (1 + p_np)
    # comparable convergence to the unsharded run after the same budget
    assert float(res_sh.check.p) <= 10 * float(res_plain.check.p) + 1e-9
    assert float(res_sh.check.d) <= 10 * float(res_plain.check.d) + 1e-9


def test_2d_sharded_single_problem(rng):
    # SURVEY.md §7 step 7 "then 2D": A block-sharded over a (model_r,
    # model_c) mesh; objective-level agreement with the replicated path.
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from fos_tpu.parallel import shard_problem_2d

    m, n = 32, 32  # square on purpose: the 2D path has no shape ambiguity
    A, b, c = _lp_batch(rng, B=1, m=m, n=n)
    A, b, c = A[0], b[0], c[0]
    prob = conic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         nonneg(m), nonneg(n))
    form = HSDEForm.build(prob)
    # eps=1e-5: converges ~2k iterations; virtual-8-device execution is
    # single-threaded, so tighter settings cost many wall-clock minutes
    res_plain = fused_solve(DR(), form, form.initial_value(form.dtype),
                            max_iters=3000, eps=1e-5, checki=100)

    mesh = make_mesh((4, 2), ("model_r", "model_c"))
    A2, b2, c2 = shard_problem_2d(jnp.asarray(A), jnp.asarray(b),
                                  jnp.asarray(c), mesh)
    prob2 = conic_problem(A2, b2, c2, nonneg(m), nonneg(n))
    form2 = HSDEForm.build(prob2)
    fn = jax.jit(lambda f, x0: fused_solve(DR(), f, x0, max_iters=3000,
                                           eps=1e-5, checki=100))
    res_sh = fn(form2, form2.initial_value(form2.dtype))
    assert int(res_sh.status) == Status.OPTIMAL
    assert int(res_plain.status) == Status.OPTIMAL
    l = m + n + 1
    x_p = np.asarray(res_plain.guess[:n] / res_plain.guess[l - 1])
    x_s = np.asarray(res_sh.guess[:n] / res_sh.guess[l - 1])
    obj_p, obj_s = float(c @ x_p), float(c @ x_s)
    assert abs(obj_p - obj_s) <= 1e-4 * (1 + abs(obj_p))
    # residuals recomputed in numpy from the sharded guess must match the
    # device-computed check values
    g = np.asarray(res_sh.guess)
    x, tau = g[:n], g[l - 1]
    s = g[l + n : l + n + m]
    p_np = np.linalg.norm(A @ (x / tau) + s / tau - b) / (1 + np.linalg.norm(b))
    assert abs(p_np - float(res_sh.check.p)) < 1e-9 * (1 + p_np)


def test_hybrid_batched_rows(rng):
    # Two-level data x model layout (the pod layout for BASELINE config 5):
    # instances over the outer 'batch' axis (DCN-friendly), rows of each A
    # over the inner 'model' axis (ICI psum per CG dot).  Must agree with
    # the plain batched solve instance-by-instance.
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from fos_tpu.parallel import make_hybrid_mesh, shard_batched_form_rows

    A, b, c = _lp_batch(rng, B=2, m=16, n=24)
    m, n = A.shape[1:]
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n))
    res_plain = solve_batched(DR(), form, max_iters=3000, eps=1e-6, checki=100)

    mesh = make_hybrid_mesh(2, 4)  # outer=batch (DCN role), inner=model (ICI)
    form_sh = shard_batched_form_rows(form, mesh)
    res_sh = solve_batched(DR(), form_sh, max_iters=3000, eps=1e-6, checki=100)
    np.testing.assert_array_equal(np.asarray(res_sh.status),
                                  np.asarray(res_plain.status))
    l = m + n + 1
    for i in range(2):
        x_p = np.asarray(res_plain.guess[i, :n] / res_plain.guess[i, l - 1])
        x_s = np.asarray(res_sh.guess[i, :n] / res_sh.guess[i, l - 1])
        obj_p, obj_s = float(c[i] @ x_p), float(c[i] @ x_s)
        assert abs(obj_p - obj_s) <= 1e-4 * (1 + abs(obj_p))
        assert x_s.min() > -1e-5
        assert (b[i] - A[i] @ x_s).min() > -1e-3


def test_hybrid_mesh_validation(rng):
    from fos_tpu.parallel import make_hybrid_mesh, shard_batched_form_rows

    with pytest.raises(ValueError, match="devices"):
        make_hybrid_mesh(3, 5)
    # square (m == n) batched forms shard fine now (named-field dispatch):
    # b rides (batch, model), c stays (batch,)-only — no shape ambiguity
    if len(jax.devices()) >= 8:
        A, b, c = _lp_batch(rng, B=2, m=16, n=16)
        form = build_batched_form(A, b, c, nonneg(16), nonneg(16))
        mesh = make_mesh((2, 4))
        form_sh = shard_batched_form_rows(form, mesh)
        assert "model" in str(form_sh.b.sharding.spec)
        assert "model" not in str(form_sh.c.sharding.spec)


def test_2d_sharded_equals_row_sharded(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from fos_tpu.parallel import shard_problem_2d

    m, n = 48, 24
    A, b, c = _lp_batch(rng, B=1, m=m, n=n)
    A, b, c = A[0], b[0], c[0]
    mesh = make_mesh((2, 4), ("model_r", "model_c"))
    A2, b2, c2 = shard_problem_2d(jnp.asarray(A), jnp.asarray(b),
                                  jnp.asarray(c), mesh)
    prob2 = conic_problem(A2, b2, c2, nonneg(m), nonneg(n))
    form2 = HSDEForm.build(prob2)
    fn = jax.jit(lambda f, x0: fused_solve(DR(), f, x0, max_iters=2000,
                                           eps=1e-7, checki=100))
    res2 = fn(form2, form2.initial_value(form2.dtype))

    prob1 = conic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                          nonneg(m), nonneg(n))
    form1 = HSDEForm.build(prob1)
    res1 = fused_solve(DR(), form1, form1.initial_value(form1.dtype),
                       max_iters=2000, eps=1e-7, checki=100)
    assert int(res2.status) == int(res1.status)
    l = m + n + 1
    x1 = np.asarray(res1.guess[:n] / res1.guess[l - 1])
    x2 = np.asarray(res2.guess[:n] / res2.guess[l - 1])
    assert abs(float(c @ x1) - float(c @ x2)) <= 1e-5 * (1 + abs(float(c @ x1)))


def test_batched_direct_matches_indirect():
    """build_batched_form(direct=True) uses batched QR least-squares maps
    (same conditioning-safe construction as the single-problem projector)."""
    A, b, c = _lp_batch(np.random.default_rng(5), B=3, m=12, n=18)
    m, n = A.shape[1:]
    fd = build_batched_form(A, b, c, nonneg(m), nonneg(n), direct=True)
    fi = build_batched_form(A, b, c, nonneg(m), nonneg(n))
    rd = solve_batched(DR(), fd, max_iters=10000, eps=1e-6, checki=100)
    ri = solve_batched(DR(), fi, max_iters=10000, eps=1e-6, checki=100)
    assert np.all(np.asarray(rd.status) == Status.OPTIMAL)
    # batched fac == the single-problem QR construction, bit-for-bit
    prob2 = conic_problem(jnp.asarray(A[1]), jnp.asarray(b[1]),
                          jnp.asarray(c[1]), nonneg(m), nonneg(n))
    fs = HSDEForm.build(prob2, direct=True)
    np.testing.assert_array_equal(np.asarray(fd.sets.s1.fac[1]),
                                  np.asarray(fs.sets.s1.fac))
    # objective-level agreement with the indirect batch (trajectories
    # differ: exact projections vs scheduled CG)
    l = m + n + 1
    for i in range(3):
        xd = np.asarray(rd.guess[i, :n] / rd.guess[i, l - 1])
        xi = np.asarray(ri.guess[i, :n] / ri.guess[i, l - 1])
        od, oi = float(c[i] @ xd), float(c[i] @ xi)
        assert abs(od - oi) <= 1e-4 * (1 + abs(oi))


def test_row_sharding_square_problem(rng):
    """r2 weak item 3: sharding keys on the form's named fields now, so
    square (m == n) problems row-shard instead of hard-erroring."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    m = n = 24
    A, b, c = _lp_batch(rng, B=1, m=m, n=n)
    A, b, c = A[0], b[0], c[0]
    prob = conic_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         nonneg(m), nonneg(n))
    form = HSDEForm.build(prob)
    mesh = make_mesh((1, 8), ("batch", "model"))
    form_sh = shard_problem_rows(form, mesh)
    # b sharded over the model axis, c replicated — named-field dispatch
    assert "model" in str(form_sh.b.sharding.spec)
    assert form_sh.c.sharding.spec == jax.sharding.PartitionSpec()
    res_plain = fused_solve(DR(), form, form.initial_value(form.dtype),
                            max_iters=1500, eps=1e-5, checki=100)
    res_sh = fused_solve(DR(), form_sh, form.initial_value(form.dtype),
                         max_iters=1500, eps=1e-5, checki=100)
    assert int(res_sh.status) == int(res_plain.status)
    l = m + n + 1
    x_p = np.asarray(res_plain.guess[:n] / res_plain.guess[l - 1])
    x_s = np.asarray(res_sh.guess[:n] / res_sh.guess[l - 1])
    op, os_ = float(c @ x_p), float(c @ x_s)
    assert abs(op - os_) <= 1e-4 * (1 + abs(op))


def test_batched_warm_start(rng):
    """initx on solve_batched: warm-starting a perturbed batch from the
    previous solution converges with fewer sweeps (the batched twin of
    solve(..., warm_start=prev))."""
    A, b, c = _lp_batch(np.random.default_rng(7), B=3, m=16, n=24)
    m, n = A.shape[1:]
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n))
    res = solve_batched(GAPA(0.8, 0.9), form, max_iters=20000, eps=1e-7,
                        checki=100)
    assert np.all(np.asarray(res.status) == Status.OPTIMAL)
    # perturb b slightly; warm-start from the previous raw iterates
    form2 = build_batched_form(A, b * 1.001, c, nonneg(m), nonneg(n))
    warm = solve_batched(GAPA(0.8, 0.9), form2, max_iters=20000, eps=1e-7,
                         checki=100, initx=res.state.x)
    cold = solve_batched(GAPA(0.8, 0.9), form2, max_iters=20000, eps=1e-7,
                         checki=100)
    assert np.all(np.asarray(warm.status) == Status.OPTIMAL)
    assert int(np.max(np.asarray(warm.iters))) <= \
        int(np.max(np.asarray(cold.iters)))


def test_solve_batched_segmented_identical(rng):
    """segment_iters resumes the FULL solver state: on this x64 battery
    (where every boundary guess-check agrees with the chunk schedule) the
    segmented solve reproduces one long fused run exactly — statuses,
    iteration counts, iterates.  In general boundary checks may terminate
    an instance earlier with an equally valid certificate (see the
    solve_batched docstring)."""
    from fos_tpu.parallel.batched import build_batched_form, solve_batched

    B, m, n = 4, 16, 24
    A = rng.standard_normal((B, m, n))
    xs = np.abs(rng.standard_normal((B, n)))
    b = np.einsum("bmn,bn->bm", A, xs) + np.abs(rng.standard_normal((B, m)))
    c = np.abs(rng.standard_normal((B, n)))
    form = build_batched_form(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                              nonneg(m), nonneg(n))
    full = solve_batched(DR(), form, max_iters=8000, eps=1e-7, checki=100)
    seg = solve_batched(DR(), form, max_iters=8000, eps=1e-7, checki=100,
                        segment_iters=700)  # non-divisible on purpose
    np.testing.assert_array_equal(np.asarray(seg.status),
                                  np.asarray(full.status))
    np.testing.assert_array_equal(np.asarray(seg.iters),
                                  np.asarray(full.iters))
    np.testing.assert_allclose(np.asarray(seg.guess), np.asarray(full.guess),
                               rtol=1e-12, atol=1e-12)
    # history chunks concatenate to the same total
    fh = solve_batched(DR(), form, max_iters=3000, eps=0.0, checki=100,
                       record_history=True, segment_iters=1000)
    assert fh.hist.shape[1] == 30
    # non-divisible budget WITH history: the last segment has fewer chunks
    # (used to crash the merge with an incompatible-shapes error)
    fh2 = solve_batched(DR(), form, max_iters=2500, eps=0.0, checki=100,
                        record_history=True, segment_iters=1000)
    assert fh2.hist.shape[1] == 25


def test_row_sharded_sparse_op(rng):
    """RowShardedOp: tile tables sharded over the model axis, local Pallas
    kernels under shard_map, one tiled all-gather per matvec — the
    multi-chip story for blocked-ELL/banded A (previously the sharding
    layer could only punt to shard_problem_2d for sparse data)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import scipy.sparse as sp

    from fos_tpu.linalg.sparse_ell import (BandedBlockOp, BlockedEllOp,
                                           RowShardedOp)

    # banded 2048x2048 (16 block rows -> 2 per device)
    m = n = 2048
    diags = [np.ones(m - abs(o)) * (1.0 + o) for o in (-130, 0, 130)]
    A = sp.diags(diags, offsets=[-130, 0, 130], shape=(m, n),
                 format="csr").astype(np.float32)
    mesh = make_mesh((1, 8), ("batch", "model"))
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    for cls in (BandedBlockOp, BlockedEllOp):
        op = cls.create(A)
        sh = RowShardedOp.create(op, mesh, "model")
        np.testing.assert_allclose(np.asarray(sh.mv(jnp.asarray(x))),
                                   np.asarray(op.mv(jnp.asarray(x))),
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(sh.rmv(jnp.asarray(y))),
                                   np.asarray(op.rmv(jnp.asarray(y))),
                                   atol=2e-4)
        # fused sharded pair: all-gathered A@x + psum'd partial A'z
        p1, p2 = sh.mv_pair(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(np.asarray(p1),
                                   np.asarray(op.mv(jnp.asarray(x))),
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(p2),
                                   np.asarray(op.rmv(jnp.asarray(y))),
                                   atol=2e-4)

    # non-divisible block-row counts: 640 -> 5 block rows zero-padded to 8
    A5 = sp.diags([np.ones(640)], offsets=[0], format="csr").astype(np.float32)
    op5 = BandedBlockOp.create(A5)
    sh5 = RowShardedOp.create(op5, mesh, "model")
    x5 = rng.standard_normal(640).astype(np.float32)
    np.testing.assert_allclose(np.asarray(sh5.mv(jnp.asarray(x5))), x5,
                               atol=1e-6)

    # end-to-end: a short fused budget with the sharded operator must
    # track the unsharded residuals (the budget is small — the full
    # convergence behavior is covered by the unsharded banded solve tests)
    from fos_tpu.problems.conic import ConicProblem

    rng2 = np.random.default_rng(0)
    x0 = np.abs(rng2.standard_normal(n)).astype(np.float32)
    b = (A @ x0 + np.abs(rng2.standard_normal(m))).astype(np.float32)
    c = (np.abs(rng2.standard_normal(n)) + 0.1).astype(np.float32)
    op = BandedBlockOp.create(A)
    sh = RowShardedOp.create(op, mesh, "model")
    form_p = HSDEForm.build(ConicProblem(op, jnp.asarray(b), jnp.asarray(c),
                                         nonneg(m), nonneg(n)),
                            densify=False)
    form_s = HSDEForm.build(ConicProblem(sh, jnp.asarray(b), jnp.asarray(c),
                                         nonneg(m), nonneg(n)),
                            densify=False)
    rp = fused_solve(DR(), form_p, form_p.initial_value(form_p.dtype),
                     max_iters=200, eps=1e-5, checki=100)
    rs = fused_solve(DR(), form_s, form_s.initial_value(form_s.dtype),
                     max_iters=200, eps=1e-5, checki=100)
    assert int(rs.status) == int(rp.status)
    assert float(rs.check.p) <= 3 * float(rp.check.p) + 1e-6
    assert float(rs.check.d) <= 3 * float(rp.check.d) + 1e-6


def test_row_sharded_sparse_op_hierarchical(rng):
    """RowShardedOp over a TUPLE of mesh axes (the multi-host layout): block
    rows split over the ("dcn", "ici") product, result gathered ici-first
    then dcn — must agree with the unsharded operator and with the
    single-axis sharding."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import scipy.sparse as sp

    from fos_tpu.linalg.sparse_ell import (BandedBlockOp, BlockedEllOp,
                                           RowShardedOp)

    m, n = 2048, 1664          # 16 x 13 block grid (rectangular)
    diags = [np.ones(min(m, n) - 0) * 2.0,
             np.ones(min(m, n - 140)) * -1.0]
    A = sp.diags(diags, offsets=[0, 140], shape=(m, n),
                 format="csr").astype(np.float32)
    mesh = make_mesh((2, 4), ("dcn", "ici"))
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    for cls in (BandedBlockOp, BlockedEllOp):
        op = cls.create(A)
        sh = RowShardedOp.create(op, mesh, ("dcn", "ici"))
        assert sh.axis == ("dcn", "ici")
        np.testing.assert_allclose(np.asarray(sh.mv(jnp.asarray(x))),
                                   np.asarray(op.mv(jnp.asarray(x))),
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(sh.rmv(jnp.asarray(y))),
                                   np.asarray(op.rmv(jnp.asarray(y))),
                                   atol=2e-4)

    # pytree round-trip keeps the axes tuple (jit/scan carry the op)
    op = BandedBlockOp.create(A)
    sh = RowShardedOp.create(op, mesh, ("dcn", "ici"))
    leaves, tree = jax.tree_util.tree_flatten(sh)
    sh2 = jax.tree_util.tree_unflatten(tree, leaves)
    assert sh2.axis == ("dcn", "ici")
    np.testing.assert_allclose(np.asarray(sh2.mv(jnp.asarray(x))),
                               np.asarray(op.mv(jnp.asarray(x))), atol=2e-4)
