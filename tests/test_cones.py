"""Cone projection oracle tests.

Mirrors the reference test strategy (SURVEY.md §4): every projection is
checked against a dense/numpy oracle, plus the Moreau identity
``v = P_K(v) + P_{K*}(-(-v))``-style decompositions the reference relies on
(src/cones.jl:80-85).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fos_tpu.cones import (
    Cone,
    ConeSpec,
    exp_primal,
    exp_dual,
    free,
    nonneg,
    nonpos,
    project,
    project_dual,
    psd,
    rotated_soc,
    smat,
    soc,
    svec,
    zero,
)
from fos_tpu.cones.exp import project_exp_single


def np_soc(v):
    t, x = v[0], v[1:]
    nx = np.linalg.norm(x)
    if nx <= t:
        return v.copy()
    if nx <= -t:
        return np.zeros_like(v)
    c = 0.5 * (t + nx)
    out = np.concatenate([[c], c * x / nx])
    return out


def np_psd_svec(v):
    # scaled svec -> matrix -> clamp eigs -> svec
    L = len(v)
    d = int(round((-1 + np.sqrt(1 + 8 * L)) / 2))
    X = np.zeros((d, d))
    k = 0
    for j in range(d):
        for i in range(j, d):
            val = v[k] if i == j else v[k] / np.sqrt(2)
            X[i, j] = X[j, i] = val
            k += 1
    w, V = np.linalg.eigh(X)
    Xp = (V * np.maximum(w, 0)) @ V.T
    out = []
    for j in range(d):
        for i in range(j, d):
            out.append(Xp[i, j] if i == j else np.sqrt(2) * Xp[i, j])
    return np.array(out)


def test_elementwise(rng):
    spec = ConeSpec.concat([free(3), zero(4), nonneg(5), nonpos(2)])
    x = rng.standard_normal(spec.dim)
    y = np.asarray(project(spec, jnp.asarray(x)))
    expect = np.concatenate(
        [x[:3], np.zeros(4), np.maximum(x[3 + 4 :][:5], 0), np.minimum(x[-2:], 0)]
    )
    np.testing.assert_allclose(y, expect, atol=1e-14)


def test_soc_blocks(rng):
    spec = ConeSpec(((Cone.SOC, 4), (Cone.NONNEG, 3), (Cone.SOC, 7)))
    x = rng.standard_normal(spec.dim)
    y = np.asarray(project(spec, jnp.asarray(x)))
    np.testing.assert_allclose(y[:4], np_soc(x[:4]), atol=1e-13)
    np.testing.assert_allclose(y[4:7], np.maximum(x[4:7], 0), atol=1e-14)
    np.testing.assert_allclose(y[7:], np_soc(x[7:]), atol=1e-13)


def test_soc_cases():
    # inside, polar, boundary scaling
    inside = np.array([2.0, 1.0, 1.0])
    np.testing.assert_allclose(
        np.asarray(project(soc(3), jnp.asarray(inside))), inside, atol=1e-14
    )
    polar = np.array([-2.0, 1.0, 0.5])
    np.testing.assert_allclose(
        np.asarray(project(soc(3), jnp.asarray(polar))), np.zeros(3), atol=1e-14
    )
    outside = np.array([0.0, 3.0, 4.0])
    np.testing.assert_allclose(
        np.asarray(project(soc(3), jnp.asarray(outside))), np_soc(outside), atol=1e-13
    )


def test_rotated_soc(rng):
    spec = rotated_soc(6)
    for _ in range(50):
        x = rng.standard_normal(6) * 3
        y = np.asarray(project(spec, jnp.asarray(x)))
        # membership: 2*p*q >= ||x||^2, p, q >= 0
        p, q, tail = y[0], y[1], y[2:]
        assert p >= -1e-12 and q >= -1e-12
        assert 2 * p * q - np.dot(tail, tail) >= -1e-10
        # idempotency
        y2 = np.asarray(project(spec, jnp.asarray(y)))
        np.testing.assert_allclose(y2, y, atol=1e-10)
        # oracle via explicit rotation to standard SOC
        H = np.eye(6)
        H[:2, :2] = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
        yr = H @ np_soc(H @ x)
        np.testing.assert_allclose(y, yr, atol=1e-12)


def test_psd(rng):
    spec = psd(5)
    x = rng.standard_normal(spec.dim)
    y = np.asarray(project(spec, jnp.asarray(x)))
    np.testing.assert_allclose(y, np_psd_svec(x), atol=1e-11)
    # mixed sizes
    spec2 = ConeSpec.concat([psd(2), psd(3), psd(2)])
    x2 = rng.standard_normal(spec2.dim)
    y2 = np.asarray(project(spec2, jnp.asarray(x2)))
    np.testing.assert_allclose(y2[:3], np_psd_svec(x2[:3]), atol=1e-11)
    np.testing.assert_allclose(y2[3:9], np_psd_svec(x2[3:9]), atol=1e-11)
    np.testing.assert_allclose(y2[9:], np_psd_svec(x2[9:]), atol=1e-11)


def test_svec_smat_roundtrip(rng):
    A = rng.standard_normal((4, 4))
    X = A + A.T
    v = svec(jnp.asarray(X))
    np.testing.assert_allclose(np.asarray(smat(v)), X, atol=1e-13)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(v)), np.linalg.norm(X), atol=1e-12)


def _np_proj_exp_oracle(v):
    """Projection onto Kexp by dense sampling + scipy refinement."""
    from scipy.optimize import minimize

    def obj(p):
        return 0.5 * np.sum((p - v) ** 2)

    # parameterize boundary/interior via (x, y) with z free, constraint
    # y*exp(x/y) <= z, y >= 0.  Use slack formulation with soft constraint.
    best = None
    cands = []
    # candidate: v itself if in cone
    x, y, z = v
    if (y > 0 and y * np.exp(x / y) <= z + 1e-12) or (y == 0 and x <= 0 and z >= 0):
        return v.copy()
    # candidate: ray points
    cands.append(np.array([min(x, 0.0), 0.0, max(z, 0.0)]))
    # optimize over boundary: p = (a*s, s, s*exp(a)), s>0
    for a0 in np.linspace(-4, 4, 9):
        for s0 in [0.1, 1.0]:
            res = minimize(
                lambda w: obj(np.array([w[0] * np.exp(w[1]), np.exp(w[1]), np.exp(w[1]) * np.exp(w[0])])),
                np.array([a0, np.log(s0)]),
                method="Nelder-Mead",
                options={"xatol": 1e-12, "fatol": 1e-16, "maxiter": 2000},
            )
            a, ls = res.x
            s = np.exp(ls)
            cands.append(np.array([a * s, s, s * np.exp(a)]))
    cands.append(np.zeros(3))
    for c in cands:
        if best is None or obj(c) < obj(best):
            best = c
    return best


@pytest.mark.parametrize("seed", range(2))
def test_exp_cone_random(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        v = rng.standard_normal(3) * 2
        y = np.asarray(project_exp_single(jnp.asarray(v)))
        oracle = _np_proj_exp_oracle(v)
        d_ours = 0.5 * np.sum((y - v) ** 2)
        d_oracle = 0.5 * np.sum((oracle - v) ** 2)
        # ours must be at least as close as the sampled oracle, and feasible
        x, yy, z = y
        if yy > 1e-10:
            assert yy * np.exp(x / yy) <= z + 1e-8 * max(1, abs(z))
        else:
            assert x <= 1e-8 and z >= -1e-10 and yy >= -1e-12
        assert d_ours <= d_oracle + 1e-6


def test_exp_cone_moreau(rng):
    # Moreau decomposition: v = P_K(v) - P_{K*}(-v), <P_K(v), P_{K*}(-v)> = 0
    for _ in range(50):
        v = rng.standard_normal(3) * 3
        p = np.asarray(project(exp_primal(), jnp.asarray(v)))
        pd = np.asarray(project(exp_dual(), jnp.asarray(-v)))
        np.testing.assert_allclose(p - pd, v, atol=1e-7)
        assert abs(np.dot(p, pd)) < 1e-7


def test_dual_spec():
    spec = ConeSpec.concat([free(2), zero(3), nonneg(4), soc(5)])
    d = spec.dual()
    assert d.blocks == ((Cone.ZERO, 2), (Cone.FREE, 3), (Cone.NONNEG, 4), (Cone.SOC, 5))


def test_project_dual_moreau(rng):
    # P_{K*}(x) == x + P_K(-x) for a mixed product
    spec = ConeSpec.concat([zero(2), nonneg(3), soc(4), psd(3)])
    for _ in range(10):
        x = rng.standard_normal(spec.dim)
        lhs = np.asarray(project_dual(spec, jnp.asarray(x)))
        rhs = x + np.asarray(project(spec, jnp.asarray(-x)))
        np.testing.assert_allclose(lhs, rhs, atol=1e-10)


def test_batched_projection(rng):
    spec = ConeSpec.concat([nonneg(3), soc(4)])
    X = rng.standard_normal((6, spec.dim))
    Y = np.asarray(project(spec, jnp.asarray(X)))
    for i in range(6):
        np.testing.assert_allclose(
            Y[i], np.asarray(project(spec, jnp.asarray(X[i]))), atol=1e-13
        )


def test_psd_poly_matches_eigh(rng):
    # factorization-free PSD projection (cones/psd_poly.py) vs eigh oracle
    from fos_tpu.cones.psd_poly import psd_project_poly
    import jax

    for d in (5, 16, 48):
        B = rng.standard_normal((4, d, d))
        X = jnp.asarray((B + np.swapaxes(B, -1, -2)) / 2)
        Yp = np.asarray(psd_project_poly(X))
        for i in range(4):
            w, V = np.linalg.eigh(np.asarray(X[i]))
            Ye = (V * np.maximum(w, 0)) @ V.T
            np.testing.assert_allclose(Yp[i], Ye, atol=1e-9)


def test_psd_poly_preserves_f32_under_x64(rng):
    # Regression (VERDICT r3 weak item 1): np.float64 strong scalars inside
    # psd_project_poly promoted f32 inputs to f64 under jax_enable_x64 (on
    # by conftest here).  The poly path MUST be dtype-preserving end to
    # end: an f32 solve must not pay for f64 matmuls.
    from fos_tpu.cones.psd_poly import psd_project_poly, _spectral_bound

    B = rng.standard_normal((3, 16, 16))
    X32 = jnp.asarray((B + np.swapaxes(B, -1, -2)) / 2, dtype=jnp.float32)
    assert jax.config.jax_enable_x64  # the promotion only bites under x64
    assert _spectral_bound(X32).dtype == jnp.float32
    Y = psd_project_poly(X32)
    assert Y.dtype == jnp.float32
    # ... and through the fused projector (project.py scatter site), where
    # the leak surfaced as an f64->f32 scatter FutureWarning.
    spec = ConeSpec.concat([nonneg(3), psd(6)])
    x32 = jnp.asarray(rng.standard_normal(spec.dim), dtype=jnp.float32)
    y = project(spec, x32, psd_method="poly")
    assert y.dtype == jnp.float32
    # f64 in -> f64 out still holds
    assert psd_project_poly(X32.astype(jnp.float64)).dtype == jnp.float64


def test_project_psd_method_option(rng):
    spec = ConeSpec.concat([nonneg(3), psd(6)])
    x = jnp.asarray(rng.standard_normal(spec.dim))
    y_eigh = np.asarray(project(spec, x, psd_method="eigh"))
    y_poly = np.asarray(project(spec, x, psd_method="poly"))
    np.testing.assert_allclose(y_poly, y_eigh, atol=1e-9)


def test_psd_heterogeneous_sides_bucketed(rng):
    # Many distinct PSD sides must (a) project correctly and (b) compile
    # into few padded buckets rather than one pass per side.
    from fos_tpu.cones import psd, nonneg
    from fos_tpu.cones.project import _build_plan, project
    from fos_tpu.cones.spec import ConeSpec

    sides = [2, 3, 5, 6, 9, 16]
    spec = ConeSpec.concat([nonneg(4)] + [psd(s) for s in sides])
    plan = _build_plan(spec.blocks)
    assert len(plan["psd"]) < len(sides)  # bucketed

    x = jnp.asarray(rng.standard_normal(spec.dim))
    y = np.asarray(project(spec, x, psd_method="eigh"))

    # oracle: per-block dense eigh projection
    from fos_tpu.cones.project import svec, smat
    off = 4
    assert np.all(y[:4] >= 0)
    for s in sides:
        L = s * (s + 1) // 2
        X = np.asarray(smat(jnp.asarray(x[off : off + L])))
        w, V = np.linalg.eigh(X)
        Xp = (V * np.maximum(w, 0)) @ V.T
        expect = np.asarray(svec(jnp.asarray(Xp)))
        np.testing.assert_allclose(y[off : off + L], expect, atol=1e-10)
        off += L


def test_psd_bucketed_batch_and_dual(rng):
    from fos_tpu.cones import psd
    from fos_tpu.cones.project import project, project_dual
    from fos_tpu.cones.spec import ConeSpec

    spec = ConeSpec.concat([psd(2), psd(4), psd(7), psd(8)])
    x = jnp.asarray(rng.standard_normal((5, spec.dim)))
    y = project(spec, x, psd_method="eigh")
    # idempotence + Moreau under batching
    np.testing.assert_allclose(np.asarray(project(spec, y, psd_method="eigh")),
                               np.asarray(y), atol=1e-9)
    md = np.asarray(x + project(spec, -x, psd_method="eigh"))
    np.testing.assert_allclose(np.asarray(project_dual(spec, x, psd_method="eigh")),
                               md, atol=1e-9)


def test_psd_project_derivative_degenerate(rng):
    # Degeneracy-safe PSD-projection derivative (Daleckii-Krein divided
    # differences): the stock eigh JVP NaNs on repeated eigenvalues, which
    # every low-rank SDP optimum has.  Forward and reverse mode must both
    # be finite and match central finite differences on a matrix with a
    # REPEATED eigenvalue pair.
    from fos_tpu.cones.project import psd_project_eigh

    d = 4
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    X = jnp.asarray(Q @ np.diag([1.5, -2.0, -2.0, 0.7]) @ Q.T)  # -2 repeated
    E = rng.standard_normal((d, d))
    E = jnp.asarray((E + E.T) / 2)

    _, dY = jax.jvp(psd_project_eigh, (X,), (E,))
    assert np.isfinite(np.asarray(dY)).all()
    eps = 1e-6
    fd = (np.asarray(psd_project_eigh(X + eps * E))
          - np.asarray(psd_project_eigh(X - eps * E))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(dY), fd, atol=1e-7)

    # reverse mode (custom JVP is linear in the tangent -> transposable)
    g = jax.grad(lambda X_: jnp.sum(psd_project_eigh(X_) * E))(X)
    assert np.isfinite(np.asarray(g)).all()
    fdg = (float(jnp.sum(psd_project_eigh(X + eps * E) * E))
           - float(jnp.sum(psd_project_eigh(X - eps * E) * E))) / (2 * eps)
    assert abs(float(jnp.sum(g * E)) - fdg) < 1e-7 * (1 + abs(fdg))

    # EXACT ties (where stock eigh-AD divides by a zero gap): a diagonal
    # matrix with a repeated entry, and the zero matrix (the solver's
    # init).  Stock AD must NaN (guards against the custom rule silently
    # not being used); ours must stay finite and FD-correct.
    def stock(X_):
        w, V = jnp.linalg.eigh(X_)
        return jnp.einsum("ik,k,jk->ij", V, jnp.maximum(w, 0.0), V)

    Xt = jnp.asarray(np.diag([1.5, -2.0, -2.0, 0.7]))
    _, dstock = jax.jvp(stock, (Xt,), (E,))
    assert not np.isfinite(np.asarray(dstock)).all()
    _, dYt = jax.jvp(psd_project_eigh, (Xt,), (E,))
    fdt = (np.asarray(psd_project_eigh(Xt + eps * E))
           - np.asarray(psd_project_eigh(Xt - eps * E))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(dYt), fdt, atol=1e-7)

    Z = jnp.zeros((d, d))
    _, dz_stock = jax.jvp(stock, (Z,), (E,))
    assert not np.isfinite(np.asarray(dz_stock)).all()
    _, dz = jax.jvp(psd_project_eigh, (Z,), (E,))
    assert np.isfinite(np.asarray(dz)).all()


def test_pow_blocks_require_params():
    """Direct make_projector with POW blocks and no params must raise, not
    silently project the slices as FREE (ADVICE r2)."""
    import pytest

    from fos_tpu.cones.project import make_projector
    from fos_tpu.cones.spec import Cone

    with pytest.raises(ValueError, match="power-cone"):
        make_projector(((Cone.NONNEG, 2), (Cone.POW_PRIMAL, 3)))


def test_psd_runs_path_matches_reference():
    # Large unpadded PSD blocks take the column-runs fast path (no element
    # gather/scatter — see _psd_project_group_runs); it must match the
    # straightforward smat -> eigh-clip -> svec reference exactly, for a
    # non-power-of-2 side, a two-block spec, a batched input, and both
    # psd methods.
    import numpy as np
    import jax
    import jax.numpy as jnp

    from fos_tpu import ConeSpec, project
    from fos_tpu.cones.project import (_build_plan, psd_project_eigh, smat,
                                       svec)
    from fos_tpu.cones.spec import Cone

    d = 300
    L = d * (d + 1) // 2
    spec = ConeSpec(((Cone.PSD, L), (Cone.PSD, L)))
    plan = _build_plan(spec.blocks, ())
    assert all("run_starts" in g for g in plan["psd"]), "runs path not taken"

    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 2 * L)))  # batched
    y = project(spec, x, psd_method="eigh")
    for k in range(2):
        Xk = smat(x[..., k * L:(k + 1) * L])
        ref = svec(psd_project_eigh(Xk))
        np.testing.assert_allclose(np.asarray(y[..., k * L:(k + 1) * L]),
                                   np.asarray(ref), atol=1e-12)

    # poly path executes through the same wrap (CPU: just check it runs
    # and lands near eigh — poly tolerance, not wrap tolerance)
    yp = project(spec, jnp.asarray(x, jnp.float32), psd_method="poly")
    np.testing.assert_allclose(np.asarray(yp), np.asarray(y), atol=5e-3)

    # below the side threshold the legacy path still serves (no runs keys)
    small = ConeSpec(((Cone.PSD, 10 * 11 // 2),))
    plan_s = _build_plan(small.blocks, ())
    assert all("run_starts" not in g for g in plan_s["psd"])
