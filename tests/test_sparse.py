"""Sparse-A path: blocked-ELL operator, sparse equilibration, end-to-end.

Reference parity targets: sparse matvec correctness at 0.001 density on a
1000x2000 matrix (/root/reference/test/HSDEAffine.jl:84-90) and the sparse
LP of testprint.jl:21-46; the tile operators replace Julia's
SparseMatrixCSC matvec (HSDEAffine.jl:41-59).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.experimental.sparse import BCOO

from fos_tpu import DR, GAPA, solve
from fos_tpu.cones import nonneg, zero
from fos_tpu.linalg.sparse_ell import BlockedEllOp, bell_storage_ratio
from fos_tpu.problems.conic import conic_problem
from fos_tpu.problems.hsde import HSDEForm


def _rand_sparse(m, n, density, seed=5):
    return sp.random(m, n, density=density,
                     random_state=np.random.RandomState(seed), format="csr")


def test_bell_matches_scipy_0001_density():
    # the reference's sparse oracle point: 1000x2000 @ 0.001
    A = _rand_sparse(1000, 2000, 0.001)
    op = BlockedEllOp.create(A)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2000).astype(np.float32)
    y = rng.standard_normal(1000).astype(np.float32)
    assert np.abs(np.asarray(op.mv(jnp.asarray(x))) - A @ x).max() < 1e-4
    assert np.abs(np.asarray(op.rmv(jnp.asarray(y))) - A.T @ y).max() < 1e-4
    assert np.abs(np.asarray(op.todense()) - A.toarray()).max() < 1e-6


def test_bell_banded_occupancy():
    # block-structured sparsity is where the tile format pays off
    m = n = 1024
    rng = np.random.default_rng(1)
    A = sp.diags([rng.standard_normal(m - abs(o)) for o in range(-20, 21)],
                 offsets=list(range(-20, 21)), shape=(m, n), format="csr")
    op = BlockedEllOp.create(A)
    assert op.occupancy() < 0.5
    x = rng.standard_normal(n).astype(np.float32)
    assert np.abs(np.asarray(op.mv(jnp.asarray(x))) - A @ x).max() < 1e-3
    assert bell_storage_ratio(A) < 0.8  # (both layouts, ELL-padded) vs dense


def test_bell_empty_rows_and_tall():
    # rows/cols with no nonzeros at all + non-multiple-of-128 shapes
    A = sp.csr_matrix((np.ones(3), ([5, 200, 399], [7, 0, 250])), shape=(400, 300))
    op = BlockedEllOp.create(A)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(300).astype(np.float32)
    y = rng.standard_normal(400).astype(np.float32)
    assert np.abs(np.asarray(op.mv(jnp.asarray(x))) - A @ x).max() < 1e-5
    assert np.abs(np.asarray(op.rmv(jnp.asarray(y))) - A.T @ y).max() < 1e-5


def _sparse_lp(m=300, n=600, density=0.02, seed=11):
    """LP with a constructed primal-dual certificate and sparse A."""
    rng = np.random.default_rng(seed)
    A = _rand_sparse(m, n, density, seed)
    xmask = rng.random(n) < 0.5
    x0 = np.abs(rng.standard_normal(n)) * xmask
    r0 = np.abs(rng.standard_normal(n)) * (~xmask)
    ymask = rng.random(m) < 0.5
    y0 = np.abs(rng.standard_normal(m)) * ymask
    s0 = np.abs(rng.standard_normal(m)) * (~ymask)
    b = A @ x0 + s0
    c = r0 - A.T @ y0
    return A, b, c, float(c @ x0)


def test_sparse_solve_bell_end_to_end():
    # scipy input -> BCOO -> forced blocked-ELL; f32 + compensated checks
    A, b, c, opt = _sparse_lp()
    sol = solve(A, b, c, nonneg(A.shape[0]), nonneg(A.shape[1]), alg=DR(),
                eps=1e-5, verbose=0, dtype=jnp.float32, densify=False,
                sparse_format="bell", max_iters=20000)
    assert sol.status == "Optimal"
    assert abs(sol.objval - opt) / abs(opt) < 5e-3
    # and it agrees with the densified path's solution
    sol_d = solve(np.asarray(A.todense()), b, c, nonneg(A.shape[0]),
                  nonneg(A.shape[1]), alg=DR(), eps=1e-5, verbose=0,
                  dtype=jnp.float32, max_iters=20000)
    assert abs(sol.objval - sol_d.objval) / abs(sol_d.objval) < 1e-3


def test_sparse_equilibration():
    # badly scaled sparse problem: equilibrate must accept sparse A now
    A, b, c, opt = _sparse_lp(m=200, n=400, density=0.03, seed=3)
    R = sp.diags(10.0 ** np.random.default_rng(4).integers(-3, 4, 200).astype(float))
    C = sp.diags(10.0 ** np.random.default_rng(5).integers(-3, 4, 400).astype(float))
    Ab = R @ A @ C
    bb = R @ b
    cb = C @ c
    # NOTE eps: the check keeps the reference's normalize-twice quirk
    # (p/(1+||b||) <= eps*(1+||b||)); with ||b|| ~ 2e4 here eps must be tiny
    # for the scaled residual itself to be small.
    sol = solve(Ab, bb, cb, nonneg(200), nonneg(400), alg=DR(), eps=1e-8,
                verbose=0, equilibrate=True, densify=False, max_iters=40000)
    assert sol.status == "Optimal"
    # unscaled residuals of the returned solution on the ORIGINAL data
    # (measured 1.2e-5 at this operating point)
    x = np.asarray(sol.x)
    s = np.asarray(sol.s)
    assert np.linalg.norm(Ab @ x + s - bb) / (1 + np.linalg.norm(bb)) < 1e-4


def test_sparse_equilibrate_matches_dense():
    from fos_tpu.cones.spec import ConeSpec
    from fos_tpu.problems.scaling import ruiz_equilibrate, ruiz_equilibrate_sparse

    A, b, c, _ = _sparse_lp(m=100, n=150, density=0.1, seed=9)
    K1, K2 = nonneg(100), nonneg(150)
    As, bs, cs, d, e = ruiz_equilibrate_sparse(A, b, c, K1, K2)
    Ad, bd, cd, dd, ed = ruiz_equilibrate(np.asarray(A.todense()), b, c, K1, K2)
    assert np.abs(np.asarray(As.todense()) - Ad).max() < 1e-10
    assert np.abs(d - dd).max() < 1e-12
    assert np.abs(e - ed).max() < 1e-12


def test_auto_format_keeps_dense_for_full_tiles():
    # a uniformly-filled sparse matrix should NOT pick blocked-ELL
    A = _rand_sparse(256, 256, 0.05)
    assert bell_storage_ratio(A) >= 0.5
    prob = conic_problem(A, np.ones(256), np.ones(256), nonneg(256), nonneg(256))
    form = HSDEForm.build(prob, densify=False)
    assert isinstance(form.A, BCOO)  # auto keeps BCOO (f64 data under x64)


def test_gap_stall_auto_recovery():
    # f32 + default CG floor stalls on this LP (p/d pass, gap stuck at
    # ~0.007 vs optimum ~0.0006); the engine must detect the stall and
    # tighten the CG floor automatically, reaching Optimal (measured:
    # Indeterminate without recovery, Optimal at ~13000 iters with it).
    # The recovery logic is format-independent (engine.py), so this runs
    # the cheap BCOO path; the tile formats are exercised by the other
    # tests.
    A = _rand_sparse(120, 200, 0.05, seed=2)
    rng = np.random.default_rng(0)
    x0 = np.abs(rng.standard_normal(200))
    b = A @ x0 + np.abs(rng.standard_normal(120))
    c = np.abs(rng.standard_normal(200))
    sol = solve(A, b, c, nonneg(120), nonneg(200), alg=DR(), eps=1e-5,
                verbose=0, densify=False, sparse_format="bcoo",
                max_iters=20000, dtype=jnp.float32)
    assert sol.status == "Optimal"
    sol64 = solve(A, b, c, nonneg(120), nonneg(200), alg=DR(), eps=1e-5,
                  verbose=0, densify=False, max_iters=20000)
    assert abs(sol.objval - sol64.objval) < 2e-3 * (1 + abs(sol64.objval))


def test_bell_requires_f32_loudly():
    """sparse_format='bell' under f64 data must raise, not silently fall
    back to the slow BCOO path (ADVICE r2)."""
    import pytest

    A = _rand_sparse(32, 48, 0.05, seed=3)
    rng = np.random.default_rng(0)
    b = np.abs(A @ np.abs(rng.standard_normal(48)) + 0.1)
    c = np.abs(rng.standard_normal(48))
    with pytest.raises(ValueError, match="bell"):
        solve(A, b, c, nonneg(32), nonneg(48), alg=DR(), verbose=0,
              densify=False, sparse_format="bell", max_iters=10)


def _banded_scipy(m, n, bw, seed):
    """Random banded matrix: nonzeros within |i - j| <= bw."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        nz = rng.integers(1, 4)
        cs = rng.integers(lo, hi, nz)
        rows.extend([i] * nz)
        cols.extend(cs.tolist())
        vals.extend(rng.standard_normal(nz).tolist())
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


def test_banded_block_op_matvec_oracle():
    from fos_tpu.linalg.sparse_ell import BandedBlockOp, band_span_ratio

    A = _banded_scipy(1000, 1200, 150, seed=4).astype(np.float32)
    assert band_span_ratio(A) <= 1.25
    op = BandedBlockOp.create(A)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1200).astype(np.float32)
    y = rng.standard_normal(1000).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(x))), A @ x,
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(op.rmv(jnp.asarray(y))), A.T @ y,
                               rtol=2e-5, atol=2e-4)
    # dense reconstruction round-trips
    np.testing.assert_allclose(np.asarray(op.todense()), A.toarray(),
                               atol=1e-6)


def test_banded_mv_pair_oracle():
    """Fused (A@x, A'@z) pair from one tile stream == separate mv/rmv ==
    scipy, including non-square shapes and window overlap accumulation."""
    from fos_tpu.linalg.sparse_ell import BandedBlockOp, BlockedEllOp

    for cls in (BandedBlockOp, BlockedEllOp):
        for m, n, bw in ((1000, 1200, 150), (1200, 1000, 250), (512, 512, 100)):
            A = _banded_scipy(m, n, bw, seed=4).astype(np.float32)
            op = cls.create(A)
            rng = np.random.default_rng(0)
            x = rng.standard_normal(n).astype(np.float32)
            z = rng.standard_normal(m).astype(np.float32)
            y1, y2 = op.mv_pair(jnp.asarray(x), jnp.asarray(z))
            np.testing.assert_allclose(np.asarray(y1), A @ x,
                                       rtol=2e-5, atol=2e-4)
            np.testing.assert_allclose(np.asarray(y2), A.T @ z,
                                       rtol=2e-5, atol=2e-4)
            # and the pair is what q_mul consumes (hsde_ops.mv_pair dispatch)
            from fos_tpu.linalg import hsde_ops

            p1, p2 = hsde_ops.mv_pair(op, jnp.asarray(x), jnp.asarray(z))
            np.testing.assert_allclose(np.asarray(p1), np.asarray(y1),
                                       atol=1e-6)
            np.testing.assert_allclose(np.asarray(p2), np.asarray(y2),
                                       atol=1e-6)

    # ELL with genuinely scattered (non-banded) columns
    A = sp.random(700, 900, density=0.01,
                  random_state=np.random.RandomState(9), format="csr")
    A = A.astype(np.float32)
    op = BlockedEllOp.create(A)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(900).astype(np.float32)
    z = rng.standard_normal(700).astype(np.float32)
    y1, y2 = op.mv_pair(jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(np.asarray(y1), A @ x, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(y2), A.T @ z, rtol=2e-5, atol=2e-4)


def test_banded_wide_span_slabs():
    """Wide windows (uniform 3% density -> every tile occupied -> S = ncb
    = 16) must keep mv/rmv/mv_pair exact."""
    from fos_tpu.linalg.sparse_ell import BandedBlockOp

    A = sp.random(2048, 2048, density=0.03,
                  random_state=np.random.RandomState(31), format="csr")
    A = A.astype(np.float32)
    op = BandedBlockOp.create(A)
    assert op.blocks.shape[1] == 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2048).astype(np.float32)
    z = rng.standard_normal(2048).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(x))), A @ x,
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(op.rmv(jnp.asarray(z))), A.T @ z,
                               rtol=2e-5, atol=2e-4)
    y1, y2 = op.mv_pair(jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(np.asarray(y1), A @ x, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(y2), A.T @ z, rtol=2e-5, atol=2e-4)


def test_banded_auto_selected_and_solves():
    """auto sparse_format picks the banded layout for banded matrices and
    the solve matches the densified path."""
    from fos_tpu.linalg.sparse_ell import BandedBlockOp

    # auto selection needs the padded tile ratio to beat 0.5 -> large grid
    Abig = _banded_scipy(4096, 4096, 150, seed=6).astype(np.float32)
    prob_big = conic_problem(
        Abig, jnp.ones(4096, jnp.float32), jnp.ones(4096, jnp.float32),
        nonneg(4096), nonneg(4096))
    form = HSDEForm.build(prob_big, densify=False)
    assert isinstance(form.sets.s1.A, BandedBlockOp), type(form.sets.s1.A)

    # e2e: forced bell routes banded matrices through BandedBlockOp too
    A = _banded_scipy(512, 512, 100, seed=6).astype(np.float32)
    rng = np.random.default_rng(1)
    x0 = np.abs(rng.standard_normal(512)).astype(np.float32)
    b = (A @ x0 + np.abs(rng.standard_normal(512))).astype(np.float32)
    c = np.abs(rng.standard_normal(512)).astype(np.float32) + 0.1
    prob = conic_problem(A, jnp.asarray(b), jnp.asarray(c),
                         nonneg(512), nonneg(512))
    form_b = HSDEForm.build(prob, densify=False, sparse_format="bell")
    assert isinstance(form_b.sets.s1.A, BandedBlockOp), type(form_b.sets.s1.A)
    sol = solve(A, b, c, nonneg(512), nonneg(512), alg=DR(), eps=1e-5,
                verbose=0, densify=False, sparse_format="bell",
                max_iters=20000, dtype=jnp.float32)
    sol_d = solve(np.asarray(A.toarray()), b, c, nonneg(512), nonneg(512),
                  alg=DR(), eps=1e-5, verbose=0, max_iters=20000,
                  dtype=jnp.float32)
    assert sol.status == "Optimal" == sol_d.status
    assert abs(sol.objval - sol_d.objval) < 2e-3 * (1 + abs(sol_d.objval))


def test_fused_gap_stall_recovery_on_device():
    """The fused engine recovers gap stalls ON DEVICE (traced CGState.floor
    tightened after 3 stalled checks) — previously only the chunked engine
    recovered, so batched/sharded f32 runs were exposed."""
    from fos_tpu.solvers.engine import fused_solve
    from fos_tpu.solvers.status import Status

    A = _rand_sparse(120, 200, 0.05, seed=2)
    rng = np.random.default_rng(0)
    x0 = np.abs(rng.standard_normal(200))
    b = (A @ x0 + np.abs(rng.standard_normal(120))).astype(np.float32)
    c = np.abs(rng.standard_normal(200)).astype(np.float32)
    prob = conic_problem(A.astype(np.float32), jnp.asarray(b),
                         jnp.asarray(c), nonneg(120), nonneg(200))
    form = HSDEForm.build(prob, densify=False, sparse_format="bcoo")
    r = fused_solve(DR(), form, form.initial_value(form.dtype),
                    max_iters=20000, eps=1e-5, checki=100)
    assert int(r.status) == Status.OPTIMAL
    # the traced floor must actually have tightened
    default = 2 * form.l * float(jnp.finfo(jnp.float32).eps)
    assert float(r.state.s1_state.floor) < 0.1 * default


def test_duplicate_coo_entries_sum():
    """BCOO semantics: duplicate indices SUM; the ELL/banded builders must
    not silently keep only the last duplicate (code-review r3)."""
    from fos_tpu.linalg.sparse_ell import BandedBlockOp

    idx = np.array([[0, 0], [0, 0], [1, 2]])
    data = np.array([1.0, 2.0, 0.5], np.float32)
    A = BCOO((jnp.asarray(data), jnp.asarray(idx)), shape=(4, 4))
    dense = np.asarray(A.todense())   # BCOO todense sums: A[0,0] == 3
    assert dense[0, 0] == 3.0
    x = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    for op_cls in (BlockedEllOp, BandedBlockOp):
        op = op_cls.create(A)
        np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(x))),
                                   dense @ x, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(np.ones(4, np.float32)))),
            dense.T @ np.ones(4), atol=1e-6)


def test_row_sharding_rejects_sparse_operators():
    """BCOO has .ndim, so the dense-duck guard must check .todense too
    (code-review r3: previously crashed inside device_put)."""
    import pytest

    from fos_tpu.parallel import make_mesh, shard_problem_rows

    A = _rand_sparse(24, 16, 0.2, seed=1)
    prob = conic_problem(A, np.ones(24), np.ones(16), nonneg(24), nonneg(16))
    form = HSDEForm.build(prob, densify=False)
    mesh = make_mesh((1, len(jax.devices())), ("batch", "model"))
    with pytest.raises(ValueError, match="shard_problem_2d"):
        shard_problem_rows(form, mesh)
