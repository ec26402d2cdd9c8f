"""Projection onto the exponential cone.

The reference outsources this to ProximalOperators' ``IndExpPrimal`` /
``IndExpDual`` (/root/reference/src/cones.jl:12-13); here it is implemented
natively as a jit-safe, vmappable univariate root find so thousands of
3-dimensional exp-cone blocks project in one fused vectorized pass.

Definitions (MathProgBase / SCS ordering ``(x, y, z)``):

    Kexp  = cl{ (x,y,z) : y > 0, y*exp(x/y) <= z }
    Kexp* = cl{ (u,v,w) : u < 0, -u*exp(v/u) <= e*w } ∪ {(0,v,w): v,w >= 0}

Method: the non-trivial projection ``p = (a*x2, x2, x2*e^a)`` lies on the
boundary with multiplier ``mu > 0`` so that ``v0 - p = -mu * (e^a,
e^a*(1-a), -1)``.  Eliminating ``(x2, mu)`` from the three stationarity
equations gives the univariate root problem

    h(rho) = ((rho-1)*r + s)*e^rho + (rho*s - r)*e^(-rho) - (rho^2-rho+1)*t

with ``x2 = ((rho-1)*r + s) / (rho^2 - rho + 1)`` — note the denominator
``rho^2-rho+1 >= 3/4`` never vanishes.  This is the same reduction as
H. Friberg, "Projection onto the exponential cone: a univariate root-finding
problem" (2021), used by SCS.  We bracket the root from the positivity
constraints ``x2 > 0`` and ``mu > 0`` and run a fixed-iteration bisection
(jit-friendly: no data-dependent trip counts), followed by a few Newton
polish steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EXPANSION_ITERS = 64
_BISECTION_ITERS = 96
_NEWTON_ITERS = 8


def _ab(rho, r, s):
    """``a = (rho-1)*r + s`` and ``b = rho*s - r``, written through their
    roots ``1 - s/r`` and ``r/s`` (the bracket ends in
    :func:`_hard_case_root`) where those are finite.  At a bracket end the
    factored form is exactly 0; the expanded form leaves a rounding residue
    whose sign depends on how the compiler fuses the multiply-add, and a
    wrong sign there sends the bracket search far from the root (seen for
    r=0.0105, s=-0.787, t=0.24: rho ~1e19 on the CPU, and z = 3e53 from
    a vector of this kind on the GPU)."""
    c1 = 1.0 - s / jnp.where(r != 0, r, 1.0)
    c2 = r / jnp.where(s != 0, s, 1.0)
    a = jnp.where((r != 0) & jnp.isfinite(c1), r * (rho - c1),
                  (rho - 1.0) * r + s)
    b = jnp.where((s != 0) & jnp.isfinite(c2), s * (rho - c2), rho * s - r)
    return a, b


def _h(rho, r, s, t):
    quad = rho * (rho - 1.0) + 1.0
    a, b = _ab(rho, r, s)
    return a * jnp.exp(rho) + b * jnp.exp(-rho) - quad * t


def _h_sign(rho, r, s, t):
    """h(rho) scaled by exp(-|rho|) — same sign, never overflows.

    Degenerate inputs (e.g. r = 1e-12, s = -1: lb1 = 1 - s/r ~ 1e12) put
    the root where exp(rho) overflows; the raw ``_h`` then evaluates
    0 * inf = NaN and the bisection collapses to NaN.  Multiplying by the
    positive factor exp(-rho) (rho >= 0) / exp(rho) (rho < 0) preserves
    the sign with all exponentials bounded by 1."""
    pos = rho >= 0
    e1 = jnp.exp(-jnp.abs(rho))
    e2 = e1 * e1
    quad = rho * (rho - 1.0) + 1.0
    a, b = _ab(rho, r, s)
    # group as quad * (t * e1): left-to-right (quad*t)*e1 overflows to
    # inf before the underflowed e1=0 multiplies in, making inf*0 = NaN
    # (seen at rho=1e30-scale brackets with |t| ~ 1e30)
    qte = quad * (t * e1)
    return jnp.where(pos, a + b * e2 - qte, a * e2 + b - qte)


def _h_grad(rho, r, s, t):
    return (
        (rho * r + s) * jnp.exp(rho)
        + (r - (rho - 1.0) * s) * jnp.exp(-rho)
        - (2.0 * rho - 1.0) * t
    )


def _in_primal(r, s, t):
    # Membership s*e^(r/s) <= t tested in log space (log s + r/s <= log t) so
    # extreme-magnitude points (e.g. r/s = 100, t = 1e30) classify exactly —
    # a clamped exponent would misreport them as members.  s > 0 forces the
    # LHS positive, so t must be > 0 in the interior.
    s_safe = jnp.where(s > 0, s, 1.0)
    t_safe = jnp.where(t > 0, t, 1.0)
    interior = (s > 0) & (t > 0) & (jnp.log(s_safe) + r / s_safe <= jnp.log(t_safe))
    boundary = (s == 0) & (r <= 0) & (t >= 0)
    return interior | boundary


def _in_polar(r, s, t):
    # v0 in polar(Kexp)  <=>  -v0 in Kexp*.  Interior test
    # -u*e^(v/u) <= e*w  <=>  log(-u) + v/u <= 1 + log(w) (w > 0 forced:
    # the LHS exponential is positive when u < 0).
    u, v, w = -r, -s, -t
    nu_safe = jnp.where(u < 0, -u, 1.0)
    w_safe = jnp.where(w > 0, w, 1.0)
    interior = (u < 0) & (w > 0) & (
        jnp.log(nu_safe) + v / jnp.where(u < 0, u, -1.0) <= 1.0 + jnp.log(w_safe))
    boundary = (u == 0) & (v >= 0) & (w >= 0)
    return interior | boundary


def _hard_case_root(r, s, t):
    """Root of h on the interval where x2 > 0 and mu > 0."""
    big = jnp.asarray(1.0, r.dtype)

    # The root must keep x2 > 0 and mu > 0:
    #   x2*quad = (rho-1)*r + s > 0
    #   mu*quad*e^rho = r - rho*s > 0
    lb1 = jnp.where(r > 0, 1.0 - s / jnp.where(r > 0, r, 1.0), -jnp.inf)
    ub1 = jnp.where(r < 0, 1.0 - s / jnp.where(r < 0, r, 1.0), jnp.inf)
    lb2 = jnp.where(s < 0, r / jnp.where(s < 0, s, 1.0), -jnp.inf)
    ub2 = jnp.where(s > 0, r / jnp.where(s > 0, s, 1.0), jnp.inf)

    # Cap the bracket at a dtype-safe magnitude: beyond it quad = rho^2-ish
    # overflows (f32) and the regime is degenerate anyway (exp(+-rho) has
    # long over/underflowed, so the scaled sign is exactly sign((rho-1)r+s)
    # there and the root collapses onto the x2 = 0 feasibility edge).
    rho_cap = jnp.asarray(1e150 if r.dtype == jnp.float64 else 1e9, r.dtype)
    lb = jnp.clip(jnp.maximum(lb1, lb2), -rho_cap, rho_cap)
    ub = jnp.clip(jnp.minimum(ub1, ub2), -rho_cap, rho_cap)
    lb_finite = jnp.isfinite(jnp.maximum(lb1, lb2))
    ub_finite = jnp.isfinite(jnp.minimum(ub1, ub2))
    lo = jnp.where(lb_finite, lb, jnp.where(ub_finite, ub - big, -big))
    hi = jnp.where(ub_finite, ub, jnp.where(lb_finite, lb + big, big))

    h_lo = _h_sign(lo, r, s, t)
    h_hi = _h_sign(hi, r, s, t)

    # Expand the unbounded end(s) geometrically until a sign change is
    # bracketed; finite feasibility ends stay fixed (the root lies inside).
    def expand(carry, _):
        lo, hi, h_lo, h_hi, width = carry
        no_bracket = jnp.sign(h_lo) == jnp.sign(h_hi)
        new_lo = jnp.where(no_bracket & ~lb_finite,
                           jnp.maximum(lo - width, -rho_cap), lo)
        new_hi = jnp.where(no_bracket & ~ub_finite,
                           jnp.minimum(hi + width, rho_cap), hi)
        new_h_lo = jnp.where(no_bracket, _h_sign(new_lo, r, s, t), h_lo)
        new_h_hi = jnp.where(no_bracket, _h_sign(new_hi, r, s, t), h_hi)
        return (new_lo, new_hi, new_h_lo, new_h_hi, width * 2.0), None

    (lo, hi, h_lo, h_hi, _), _ = jax.lax.scan(
        expand, (lo, hi, h_lo, h_hi, big), None, length=_EXPANSION_ITERS
    )

    # Bisection (fixed iterations).  Keep the invariant sign(h(lo)) != sign(h(hi)).
    def bisect(carry, _):
        lo, hi, h_lo = carry
        mid = 0.5 * (lo + hi)
        h_mid = _h_sign(mid, r, s, t)
        go_right = jnp.sign(h_mid) == jnp.sign(h_lo)
        new_lo = jnp.where(go_right, mid, lo)
        new_hi = jnp.where(go_right, hi, mid)
        new_h_lo = jnp.where(go_right, h_mid, h_lo)
        return (new_lo, new_hi, new_h_lo), None

    (lo, hi, _), _ = jax.lax.scan(bisect, (lo, hi, h_lo), None, length=_BISECTION_ITERS)
    rho = 0.5 * (lo + hi)

    # Newton polish, clamped to the bracket.
    def newton(rho, _):
        g = _h_grad(rho, r, s, t)
        step = _h(rho, r, s, t) / jnp.where(g != 0, g, 1.0)
        new = jnp.clip(rho - step, lo, hi)
        return jnp.where(jnp.isfinite(new), new, rho), None

    rho, _ = jax.lax.scan(newton, rho, None, length=_NEWTON_ITERS)
    return rho


def project_exp_single(v):
    """Project one 3-vector ``v = (r, s, t)`` onto Kexp."""
    r, s, t = v[0], v[1], v[2]
    in_primal = _in_primal(r, s, t)
    in_polar = _in_polar(r, s, t)
    special = (r <= 0) & (s <= 0)

    # Evaluate the hard case on a safe dummy input when it doesn't apply, to
    # avoid NaNs contaminating the where().
    hard = ~(in_primal | in_polar | special)
    rh = jnp.where(hard, r, 0.0)
    sh = jnp.where(hard, s, 1.0)
    th = jnp.where(hard, t, -1.0)
    rho = _hard_case_root(rh, sh, th)
    quad = rho * (rho - 1.0) + 1.0
    a, b = _ab(rho, rh, sh)
    x2 = jnp.maximum(a / quad, 0.0)
    # z from whichever of its two equal forms does not amplify: for rho > 0
    # the multiplier stationarity z = t + mu, mu = (r - rho*s) e^(-rho) /
    # quad (x2 * e^rho would multiply x2's rounding error by e^rho and
    # overflows in the degenerate large-rho regime, e.g. r -> 0+, s < 0
    # puts the root at rho ~ -s/r); for rho <= 0, z = x2 * e^rho.
    mu = -b * jnp.exp(-jnp.abs(rho)) / quad
    z_hard = jnp.where(rho > 0, jnp.maximum(th + mu, 0.0),
                       x2 * jnp.exp(jnp.minimum(rho, 0.0)))
    p_hard = jnp.stack([rho * x2, x2, z_hard])

    p_special = jnp.stack([r, jnp.zeros_like(s), jnp.maximum(t, 0.0)])
    zero3 = jnp.zeros_like(v)

    out = jnp.where(in_primal, v, jnp.where(in_polar, zero3, jnp.where(special, p_special, p_hard)))
    return out


project_exp = jax.vmap(project_exp_single)  # (k, 3) -> (k, 3)


def project_exp_dual_single(v):
    """Project onto Kexp* via Moreau: P_{K*}(v) = v + P_K(-v).

    Mirrors the reference's generic dual prox (src/cones.jl:80-85).
    """
    return v + project_exp_single(-v)


project_exp_dual = jax.vmap(project_exp_dual_single)
