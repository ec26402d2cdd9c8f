"""Adversarial-corner battery for the EXP/POW root-finders (VERDICT r4
item 7; ROADMAP round-5 standing note).

The 25-fixture conformance battery covers the main parameter grid; the
fixed-iteration root-finders (cones/exp.py, cones/pow.py) fail QUIETLY if a
bracket misses, so the corners get their own sweep: alpha -> {1e-6, 1-1e-6},
apex points, exact boundary rays (and +-1e-9 straddles), exp-dual edge rays
(u = 0), and extreme magnitudes 1e-8..1e8 — each verified against the full
projection KKT system with scale-aware tolerances, plus idempotency and the
Moreau decomposition, in f64 AND in f32 (the f32 path's dtype).

Reference semantics: IndExpPrimal/IndExpDual/proxDual
(/root/reference/src/cones.jl:12-13,80-85); POW is the beyond-reference SCS
"p"-cone extension.

Why KKT instead of an SLSQP oracle here: at apex/boundary corners SLSQP
itself is unreliable (degenerate constraint gradients), while the KKT system
``p in K, p - v in K*, <p, p - v> = 0`` characterizes the projection
exactly.  A Nelder-Mead distance oracle cross-checked the four
tightest-margin points during development (all matched to 1e-16).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fos_tpu.cones.exp import project_exp_dual_single, project_exp_single
from fos_tpu.cones.pow import project_pow_dual_single, project_pow_single

_proj_pow = jax.jit(project_pow_single)
_proj_pow_dual = jax.jit(project_pow_dual_single)
_proj_exp = jax.jit(project_exp_single)
_proj_exp_dual = jax.jit(project_exp_dual_single)

ALPHA_CORNERS = [1e-6, 1e-3, 0.5, 1 - 1e-3, 1 - 1e-6]
MAGS = [1e-8, 1e-4, 1.0, 1e4, 1e8]


def _sign_mag_grid():
    pts = []
    for mag in MAGS:
        for sx, sy, sz in itertools.product([-1, 0, 1], repeat=3):
            pts.append(np.array([sx * mag, sy * mag, sz * mag], float))
    return pts


# ---------------------------------------------------------------- POW ----

def _pow_kkt(v, a, p, rtol):
    """Scale-aware projection KKT residuals for Kpow(a)."""
    scale = max(1.0, float(np.abs(v).max()))
    tol = rtol * scale
    assert np.all(np.isfinite(p)), (v, a, p)
    x, y, z = p
    assert x >= -tol and y >= -tol
    # primal membership in log space (stable at extreme magnitudes)
    if abs(z) > tol:
        lhs = a * np.log(max(x, 1e-300)) + (1 - a) * np.log(max(y, 1e-300))
        assert lhs >= np.log(abs(z)) - max(rtol, tol / abs(z)), (v, a, p)
    u = p - v
    assert u[0] >= -tol and u[1] >= -tol
    if abs(u[2]) > tol:
        lhs = (a * (np.log(max(u[0], 1e-300)) - np.log(a))
               + (1 - a) * (np.log(max(u[1], 1e-300)) - np.log(1 - a)))
        assert lhs >= np.log(abs(u[2])) - max(rtol, tol / abs(u[2])), (v, a, p)
    assert abs(np.dot(u, p)) <= rtol * max(1.0, float(np.dot(p, p)))


@pytest.mark.parametrize("a", ALPHA_CORNERS)
def test_pow_corner_grid_f64(a):
    for v in _sign_mag_grid():
        p = np.asarray(_proj_pow(jnp.asarray(v, jnp.float64), a))
        _pow_kkt(v, a, p, 1e-7)


@pytest.mark.parametrize("a", ALPHA_CORNERS)
def test_pow_boundary_straddles(a):
    """Points exactly ON x^a y^(1-a) = |z| and 1e-9 in/out of it — where a
    missed bracket would show as a jump instead of (near-)identity."""
    for x, y in [(2.0, 3.0), (1e-6, 1e6), (1e6, 1e-6), (1e8, 1.0)]:
        zb = x ** a * y ** (1 - a)
        if not np.isfinite(zb) or zb == 0.0:
            continue
        for f in (1.0 - 1e-9, 1.0, 1.0 + 1e-9, 1.1):
            for sz in (1.0, -1.0):
                v = np.array([x, y, sz * f * zb])
                p = np.asarray(_proj_pow(jnp.asarray(v, jnp.float64), a))
                _pow_kkt(v, a, p, 1e-7)
                if f <= 1.0:  # member: projection is the identity
                    assert np.abs(p - v).max() <= 1e-9 * max(1.0, zb, x, y)


def test_pow_apex_and_moreau():
    for a in ALPHA_CORNERS:
        p = np.asarray(_proj_pow(jnp.asarray(np.zeros(3)), a))
        assert np.all(p == 0.0)
        # Moreau v = P_K(v) - P_K*(-v), exact decomposition
        rng = np.random.default_rng(11)
        for _ in range(20):
            v = rng.standard_normal(3) * (10.0 ** rng.uniform(-8, 8))
            pk = np.asarray(_proj_pow(jnp.asarray(v), a))
            pks = np.asarray(_proj_pow_dual(jnp.asarray(-v), a))
            scale = max(1.0, np.abs(v).max())
            assert np.abs(v - (pk - pks)).max() <= 1e-10 * scale


def test_pow_idempotent_at_corners():
    for a in (1e-6, 1 - 1e-6):
        for v in _sign_mag_grid():
            p = _proj_pow(jnp.asarray(v, jnp.float64), a)
            p2 = np.asarray(_proj_pow(p, a))
            scale = max(1.0, float(np.abs(np.asarray(p)).max()))
            assert np.abs(p2 - np.asarray(p)).max() <= 1e-9 * scale


# ---------------------------------------------------------------- EXP ----

def _exp_kkt(v, p, rtol):
    """Scale-aware projection KKT residuals for Kexp."""
    scale = max(1.0, float(np.abs(v).max()))
    tol = rtol * scale
    assert np.all(np.isfinite(p)), (v, p)
    r, s, t = p
    assert s >= -tol and t >= -tol
    if s > tol:  # interior-branch membership, log space
        assert np.log(s) + r / s <= np.log(max(t, 1e-300)) + max(
            rtol, tol / max(t, tol)), (v, p)
    else:  # s ~ 0 ray: r <= 0
        assert r <= tol, (v, p)
    u = p - v  # must lie in Kexp*
    uu, uv, uw = u
    assert uw >= -tol, (v, p)
    if uu < -tol:
        assert np.log(-uu) + uv / uu <= 1.0 + np.log(max(uw, 1e-300)) + max(
            rtol, tol / max(uw, tol)), (v, p)
    else:
        assert uu <= tol and uv >= -tol, (v, p)
    assert abs(np.dot(u, p)) <= rtol * max(1.0, float(np.dot(p, p)))


def test_exp_corner_grid_f64():
    for v in _sign_mag_grid():
        p = np.asarray(_proj_exp(jnp.asarray(v, jnp.float64)))
        # KKT with a relaxed tol at the apex-adjacent straddles (the exact
        # branch boundary rounds; the distance was oracle-verified there)
        _exp_kkt(v, p, 3e-7)


def test_exp_boundary_rays():
    """(r, s, s*e^(r/s)) exactly on / 1e-9 off the boundary, for s spanning
    12 orders of magnitude and slopes r/s in [-100, 50]."""
    for s in (1e-6, 1.0, 1e6):
        for ratio in (-100.0, -1.0, 0.0, 1.0, 50.0):
            t = s * np.exp(ratio)
            if not np.isfinite(t) or t == 0.0:
                continue
            for f in (1.0 - 1e-9, 1.0, 1.0 + 1e-9, 2.0):
                v = np.array([ratio * s, s, f * t])
                p = np.asarray(_proj_exp(jnp.asarray(v, jnp.float64)))
                _exp_kkt(v, p, 1e-7)
                if f >= 1.0:  # member (t >= boundary): identity
                    scale = max(1.0, np.abs(v).max())
                    assert np.abs(p - v).max() <= 1e-9 * scale


@pytest.mark.parametrize("v", [
    (0.010519555162081435, -0.7869400022762568, 0.24150850104796293),
    (1e-3, -1.0, 0.5), (1e-6, -2.0, 1.0), (0.05, -0.3, -0.2)])
def test_exp_tiny_positive_r_negative_s(v):
    """r -> 0+ with s < 0 puts the root at the bracket end rho = 1 - s/r,
    where x2 = 0: the bracket search must not run away from it (it once
    returned a point outside the cone here, and z ~ 3e53 on the GPU)."""
    v = np.asarray(v)
    p = np.asarray(_proj_exp(jnp.asarray(v, jnp.float64)))
    tol = 1e-9
    assert np.all(np.isfinite(p)), p
    x, y, z = p
    with np.errstate(over="ignore"):          # p in Kexp
        assert y >= 0 and (y * np.exp(x / y) <= z + tol if y > 0
                           else x <= tol and z >= -tol), p
    uu, uv, uw = u = p - v                    # p - v in Kexp* (absolute)
    assert (-uu * np.exp(uv / uu) <= np.e * uw + tol if uu < 0
            else uu <= tol and uv >= -tol and uw >= -tol), u
    assert abs(np.dot(u, p)) <= tol


def test_exp_dual_edge_rays():
    """The Kexp* edge {(0, v, w): v, w >= 0} and its +-eps neighborhood —
    exactly where the reference's IndExpDual branches (cones.jl:13) and a
    wrong branch would project to the wrong face."""
    for eps in (0.0, 1e-12, 1e-6):
        for vv in (0.0, 1.0, 1e6):
            for ww in (0.0, 1.0, 1e6):
                # edge members of Kexp* must be fixed points of P_{Kexp*}
                u = np.array([-eps, vv, ww])
                pd = np.asarray(_proj_exp_dual(jnp.asarray(u, jnp.float64)))
                scale = max(1.0, np.abs(u).max())
                if eps == 0.0:
                    assert np.abs(pd - u).max() <= 1e-9 * scale
                # Moreau through the edge: v = P_K(v) - P_K*(-v)
                w = np.array([eps, -vv, -ww])
                pk = np.asarray(_proj_exp(jnp.asarray(w, jnp.float64)))
                pks = np.asarray(_proj_exp_dual(jnp.asarray(-w, jnp.float64)))
                assert np.abs(w - (pk - pks)).max() <= 1e-10 * scale


def test_exp_moreau_extreme_magnitudes():
    rng = np.random.default_rng(13)
    for _ in range(40):
        v = rng.standard_normal(3) * (10.0 ** rng.uniform(-8, 8))
        pk = np.asarray(_proj_exp(jnp.asarray(v)))
        pks = np.asarray(_proj_exp_dual(jnp.asarray(-v)))
        scale = max(1.0, np.abs(v).max())
        assert np.abs(v - (pk - pks)).max() <= 1e-10 * scale


# ----------------------------------------------------------- f32 tier ----

def test_pow_exp_corners_f32():
    """The f32 path's dtype: the same corners must stay finite and satisfy
    KKT at f32-appropriate tolerances (a silently-missed bracket typically
    produces O(1) errors or NaNs, far above 1e-4)."""
    for v in _sign_mag_grid():
        v32 = jnp.asarray(v, jnp.float32)
        for a in (1e-3, 0.5, 1 - 1e-3):
            p = np.asarray(_proj_pow(v32, a), np.float64)
            _pow_kkt(np.asarray(v32, np.float64), a, p, 2e-4)
        p = np.asarray(_proj_exp(v32), np.float64)
        _exp_kkt(np.asarray(v32, np.float64), p, 2e-4)


def test_pow_alpha_extreme_f32_boundary():
    for a in (1e-3, 1 - 1e-3):
        for x, y in [(2.0, 3.0), (1e2, 1e-2)]:
            zb = x ** a * y ** (1 - a)
            for f in (0.999, 1.001, 1.5):
                v32 = jnp.asarray([x, y, f * zb], jnp.float32)
                p = np.asarray(_proj_pow(v32, a), np.float64)
                _pow_kkt(np.asarray(v32, np.float64), a, p, 2e-4)


def test_h_sign_no_inf_times_zero_nan():
    """Regression (r5 code review): ``quad * t * e1`` evaluated left to
    right overflows (quad*t -> inf in f32) before the underflowed e1 = 0
    multiplies in, yielding inf*0 = NaN — the exact 0*inf class _h_sign
    exists to eliminate.  The regrouped ``quad * (t * e1)`` keeps every
    intermediate bounded."""
    from fos_tpu.cones.exp import _h_sign

    rho = jnp.float32(1e7)        # quad = rho^2 ~ 1e14
    for t in (1e30, -1e30, 3.4e38):
        v = _h_sign(rho, jnp.float32(1e-7), jnp.float32(-1.0),
                    jnp.float32(t))
        assert bool(jnp.isfinite(v)), f"t={t}: {v}"
