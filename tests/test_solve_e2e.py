"""End-to-end conic solves.

Equivalent of the reference's test/testDRandGAPA.jl: the README problem
``min ||Ax - b||^2  s.t.  x >= 0`` with A = 40x50 gaussian.  The reference
pins the optimum to a Julia-RNG-specific constant
(10.945929126466417, testDRandGAPA.jl:10-16); Julia's RNG is not
reproducible here, so the oracle optimum is computed with scipy's NNLS on
our own seeded data — same determinism contract.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy.optimize import nnls

from fos_tpu import DR, GAP, GAPA, solve
from fos_tpu.cones import nonneg, rotated_soc, zero, ConeSpec
from fos_tpu.cones.spec import Cone


def readme_problem(seed=2, m=40, n=50):
    """Conic form of min ||Ax-b||^2 s.t. x >= 0.

    Variables (x, t, q, w): minimize t subject to
      A x - w = b            (Zero rows)
      q = 1/2                (Zero row)
      (t, q, w) in RotatedSOC  => ||w||^2 <= 2 t q = t
      x >= 0
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)

    nv = n + 2 + m
    Ac = np.zeros((m + 1, nv))
    bc = np.zeros(m + 1)
    # rows 0..m-1:  A x - w = b
    Ac[:m, :n] = A
    Ac[:m, n + 2 :] = -np.eye(m)
    bc[:m] = b
    # row m: q = 1/2
    Ac[m, n + 1] = 1.0
    bc[m] = 0.5
    c = np.zeros(nv)
    c[n] = 1.0

    K1 = zero(m + 1)
    K2 = ConeSpec(((Cone.NONNEG, n), (Cone.SOC_ROTATED, 2 + m)))

    xstar, rnorm = nnls(A, b)
    opt = rnorm**2
    return Ac, bc, c, K1, K2, A, b, xstar, opt


@pytest.fixture(scope="module")
def readme():
    return readme_problem()


def test_dr_readme(readme):
    Ac, bc, c, K1, K2, A, b, xstar, opt = readme
    n = A.shape[1]
    sol = solve(Ac, bc, c, K1, K2, alg=DR(), eps=1e-8, max_iters=20000, verbose=0)
    assert sol.status == "Optimal"
    x = np.asarray(sol.x[:n])
    obj = np.sum((A @ x - b) ** 2)
    # same contract as testDRandGAPA.jl:21-27
    assert abs(obj - opt) / opt < 1e-6
    assert np.min(x) > -1e-6
    np.testing.assert_allclose(x, xstar, atol=1e-4)


def test_gapa_readme(readme):
    Ac, bc, c, K1, K2, A, b, xstar, opt = readme
    n = A.shape[1]
    sol = solve(Ac, bc, c, K1, K2, alg=GAPA(1.0), eps=1e-5, max_iters=20000, verbose=0)
    assert sol.status == "Optimal"
    x = np.asarray(sol.x[:n])
    obj = np.sum((A @ x - b) ** 2)
    assert abs(obj - opt) / opt < 2e-3  # testDRandGAPA.jl:29-41 contract
    np.testing.assert_allclose(x, xstar, atol=2e-2)


def test_gapa_direct_readme(readme):
    Ac, bc, c, K1, K2, A, b, xstar, opt = readme
    n = A.shape[1]
    sol = solve(Ac, bc, c, K1, K2, alg=GAPA(1.0, direct=True), eps=1e-5,
                max_iters=20000, verbose=0)
    assert sol.status == "Optimal"
    x = np.asarray(sol.x[:n])
    obj = np.sum((A @ x - b) ** 2)
    assert abs(obj - opt) / opt < 2e-3


def test_gapa_tight(readme):
    # GAPA(0.5, beta=0.9) at eps=1e-9 reaches 1e-8 relative objective error
    # (testDRandGAPA.jl:44-49)
    Ac, bc, c, K1, K2, A, b, xstar, opt = readme
    n = A.shape[1]
    sol = solve(Ac, bc, c, K1, K2, alg=GAPA(0.5, 0.9), eps=1e-9,
                max_iters=40000, verbose=0)
    assert sol.status == "Optimal"
    x = np.asarray(sol.x[:n])
    obj = np.sum((A @ x - b) ** 2)
    assert abs(obj - opt) / opt < 1e-6


def test_solution_fields(readme):
    Ac, bc, c, K1, K2, A, b, xstar, opt = readme
    sol = solve(Ac, bc, c, K1, K2, alg=DR(), eps=1e-6, max_iters=20000, verbose=0)
    assert sol.objval == pytest.approx(float(np.dot(c, np.asarray(sol.x))))
    assert sol.history is not None
    it, p = sol.history.get("p")
    assert len(it) >= 1
    assert sol.iters >= 100


def test_gapa_tight_f32_with_refine(readme):
    # The f32 path's answer to the reference's tightest contract
    # (testDRandGAPA.jl:44-49, eps=1e-9 -> 1e-8 rel-obj): main solve in f32
    # with compensated reductions, then the f64
    # refinement sweep.  Measured: rel-obj ~ 2e-11.
    import jax.numpy as jnp

    Ac, bc, c, K1, K2, A, b, xstar, opt = readme
    n = A.shape[1]
    sol = solve(Ac, bc, c, K1, K2, alg=GAPA(0.5, 0.9), eps=1e-9,
                max_iters=10000, verbose=0, dtype=jnp.float32, refine=10000)
    assert sol.status == "Optimal"
    assert sol.x.dtype == jnp.float64
    x = np.asarray(sol.x[:n])
    obj = np.sum((A @ x - b) ** 2)
    assert abs(obj - opt) / opt < 1e-8


def test_unknown_option_rejected(readme):
    Ac, bc, c, K1, K2, A, b, xstar, opt = readme
    with pytest.raises(TypeError, match="epsilon"):
        solve(Ac, bc, c, K1, K2, alg=DR(), epsilon=1e-8, verbose=0)
