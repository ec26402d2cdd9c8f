"""Homogeneous self-dual embedding of a conic program.

Reference: /root/reference/src/problemforms/HSDE/HSDE.jl (embedding),
HSDEStatus.jl (SCS-style termination).  The iterate is
``z = (u, v) in R^{2l}``, ``l = n + m + 1`` with ``u = (x, y, tau)`` and
``v = (r, s, kappa)``:

* S1 is the affine set ``{(u,v): Qu = v}`` projected by
  :class:`fos_tpu.linalg.affine.HSDEAffineProjector` (SPD-CG or cached
  direct inverse);
* S2 is the cone product ``K2 x K1* x R+  x  K2* x K1 x R+``
  (``DualConeProduct``, src/cones.jl:113-142) compiled into ONE fused
  projection over the whole 2l vector;
* termination residuals p/d/g and the unbounded/infeasible certificates are
  computed on-device from views into z (HSDEStatus.jl:27-71, 93-102).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fos_tpu.cones.spec import ConeSpec
from fos_tpu.cones import nonneg
from fos_tpu.linalg.affine import HSDEAffineProjector
from fos_tpu.linalg import hsde_ops
from fos_tpu.problems.conic import ConicProblem
from fos_tpu.solvers.base import ConeSet, TwoSets
from fos_tpu.solvers.status import Status


def hsde_cone_spec(K1: ConeSpec, K2: ConeSpec) -> ConeSpec:
    """The S2 product over z: K2 × K1* × R+ × K2* × K1 × R+
    (cones.jl:122-142: yx=P_K2, yy=P_K1*, tau=max(.,0), yr=P_K2*, ys=P_K1,
    kappa=max(.,0))."""
    return ConeSpec.concat([K2, K1.dual(), nonneg(1), K2.dual(), K1, nonneg(1)])


class HSDECheck(NamedTuple):
    """On-device convergence-check scalars (one status-table row)."""

    status: jnp.ndarray  # int32 Status code
    p: jnp.ndarray
    d: jnp.ndarray
    g: jnp.ndarray
    ctx: jnp.ndarray
    bty: jnp.ndarray
    tau: jnp.ndarray
    kappa: jnp.ndarray


@jax.tree_util.register_pytree_node_class
class HSDEForm:
    """Problem form driving the generic iteration engine."""

    def __init__(self, sets: TwoSets, A, b, c, norm_b, norm_c, n: int, m: int,
                 dinv=None, einv=None, K2_spec=None, strict_certificates=False,
                 compensated=False):
        self.sets = sets
        self.A = A
        self.b = b
        self.c = c
        self.norm_b = norm_b      # ORIGINAL ||b|| (pre-equilibration)
        self.norm_c = norm_c      # ORIGINAL ||c||
        self.n = n
        self.m = m
        self.dinv = dinv          # residual unscaling weights (equilibration)
        self.einv = einv
        self.K2_spec = K2_spec
        self.strict_certificates = strict_certificates
        self.compensated = compensated

    def tree_flatten(self):
        return (self.sets, self.A, self.b, self.c, self.norm_b, self.norm_c,
                self.dinv, self.einv), (self.n, self.m, self.K2_spec,
                                        self.strict_certificates,
                                        self.compensated)

    @classmethod
    def tree_unflatten(cls, aux, children):
        sets, A, b, c, nb, nc, dinv, einv = children
        n, m, K2_spec, strict, compensated = aux
        return cls(sets, A, b, c, nb, nc, n, m, dinv, einv, K2_spec, strict,
                   compensated)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, problem: ConicProblem, *, direct: bool = False,
              cg_max_iters: int = 1000,
              cg_tol_floor: float = None, psd_method: str = "auto",
              cg_variant: str = "standard", cg_unroll: int = 2,
              equilibrate: bool = False, equilibrate_iters: int = 10,
              strict_certificates: bool = False, densify="auto",
              compensated="auto", sparse_format="auto") -> "HSDEForm":
        A = problem.A
        b = problem.b
        c = problem.c
        # Sparse policy, decided once from the pattern: an f32 A whose
        # occupied 128x128 tiles are under half the dense tile grid is
        # packed into a tile operator (linalg/sparse_ell.py) — banded
        # layout where each row block's tiles are (near-)contiguous, else
        # blocked-ELL; "bell"/"band" force it, "bcoo" (or densify=True)
        # skips it.  Any other sparse A is densified when the dense copy
        # fits a quarter of device memory (densify="auto"; never on the
        # CPU), else kept as BCOO.  Operator inputs (BlockedEllOp/
        # BandedBlockOp/RowShardedOp) are deliberate layouts and pass
        # through.  The numbers behind this order: PERF.md, "Sparse
        # formats".
        tile = None
        if hasattr(A, "indices") and sparse_format in ("auto", "bell", "band"):
            from fos_tpu.linalg.sparse_ell import (band_span_ratio,
                                                   bell_storage_ratio)

            if jnp.dtype(b.dtype) != jnp.float32:
                if sparse_format != "auto":
                    raise ValueError(
                        f"sparse_format={sparse_format!r} requires f32 "
                        "problem data (the tile tables are f32-only); cast "
                        "with dtype=jnp.float32 or use sparse_format='bcoo'")
            elif sparse_format == "band":
                tile = "band"
            elif sparse_format == "bell" or (densify is not True
                                             and bell_storage_ratio(A) < 0.5):
                tile = "band" if band_span_ratio(A) <= 1.25 else "bell"
        if (densify and tile is None and hasattr(A, "todense")
                and not hasattr(A, "mv")):
            from fos_tpu.config import densify_fits, device_bytes_limit

            dense_bytes = A.shape[0] * A.shape[1] * jnp.dtype(b.dtype).itemsize
            if densify is True or (
                    densify == "auto"
                    and densify_fits(dense_bytes, device_bytes_limit())):
                A = A.todense()
        norm_b = jnp.linalg.norm(b)
        norm_c = jnp.linalg.norm(c)
        dinv = einv = None
        if equilibrate:
            dtype = b.dtype
            if hasattr(A, "todense"):
                # Sparse path: host-side Ruiz on the nonzeros only
                # (scaling.py: ruiz_equilibrate_sparse); A stays sparse.
                import numpy as _np
                import scipy.sparse as _sp
                from jax.experimental.sparse import BCOO as _BCOO

                from fos_tpu.problems.scaling import ruiz_equilibrate_sparse

                if not hasattr(A, "indices"):
                    raise ValueError(
                        "equilibrate needs COO-style sparse data (BCOO or "
                        "scipy.sparse); equilibrate BEFORE packing A into a "
                        "BlockedEllOp")
                idx = _np.asarray(A.indices)
                Asp = _sp.coo_matrix(
                    (_np.asarray(A.data), (idx[:, 0], idx[:, 1])), shape=A.shape)
                As, bs, cs, dvec, evec = ruiz_equilibrate_sparse(
                    Asp, b, c, problem.K1, problem.K2, iters=equilibrate_iters)
                A = _BCOO.from_scipy_sparse(As.astype(_np.dtype(dtype)))
            else:
                from fos_tpu.problems.scaling import ruiz_equilibrate

                As, bs, cs, dvec, evec = ruiz_equilibrate(
                    A, b, c, problem.K1, problem.K2, iters=equilibrate_iters)
                A = jnp.asarray(As, dtype)
            b = jnp.asarray(bs, dtype)
            c = jnp.asarray(cs, dtype)
            dinv = jnp.asarray(1.0 / dvec, dtype)
            einv = jnp.asarray(1.0 / evec, dtype)
            import dataclasses as _dc

            problem = _dc.replace(problem, A=A, b=b, c=c)
        if tile is not None:
            from fos_tpu.linalg.sparse_ell import BandedBlockOp, BlockedEllOp

            # transpose_table=False: the whole HSDE path (q_mul,
            # hsde_normal_mul, the residual check) consumes mv_pair, which
            # computes A'z from the A table — skipping the A' pack halves
            # tile memory (standalone op.rmv raises a pointer to the flag)
            op_cls = BandedBlockOp if tile == "band" else BlockedEllOp
            A = op_cls.create(A, transpose_table=False)
        # Compensated (float-float) reductions (linalg/compensated.py):
        # - convergence CHECK: auto-on for f32 data — runs once per checki,
        #   negligible cost, and makes the reported residuals / the
        #   cancellation-prone duality gap honest to ~f64 (measured: agrees
        #   with f64 recomputation to 6 digits, PERF.md);
        # - CG dot products: opt-in (compensated=True) — the ~30 extra tiny
        #   sequential ops per CG iteration cost 2.7x throughput at 1000^2
        #   where per-op overhead dominates, and plain-f32 dots already
        #   reach the default operating points.
        if compensated == "auto":
            comp_check = jnp.dtype(b.dtype) == jnp.float32
            comp_cg = False
        else:
            comp_check = comp_cg = bool(compensated)
        s1 = HSDEAffineProjector.create(
            A, b, c,
            direct=direct, decreasing_accuracy=not direct,
            cg_max_iters=cg_max_iters, tol_floor=cg_tol_floor,
            cg_variant=cg_variant, cg_unroll=cg_unroll, compensated=comp_cg,
        )
        compensated = comp_check
        s2 = ConeSet(hsde_cone_spec(problem.K1, problem.K2), psd_method)
        assert s2.spec.dim == 2 * s1.l
        return cls(
            TwoSets(s1, s2), A, b, c, norm_b, norm_c,
            problem.n, problem.m, dinv, einv,
            problem.K2, strict_certificates, compensated,
        )

    @property
    def l(self) -> int:
        return self.n + self.m + 1

    @property
    def dim(self) -> int:
        return 2 * self.l

    def initial_value(self, dtype):
        """tau = kappa = 1, everything else 0 (HSDE.jl:40-47)."""
        z = jnp.zeros(self.dim, dtype=dtype)
        z = z.at[self.l - 1].set(1.0)
        z = z.at[2 * self.l - 1].set(1.0)
        return z

    def split(self, z):
        n, m, l = self.n, self.m, self.l
        x = z[:n]
        y = z[n : n + m]
        tau = z[l - 1]
        r = z[l : l + n]
        s = z[l + n : l + n + m]
        kappa = z[2 * l - 1]
        return x, y, tau, r, s, kappa

    @property
    def dtype(self):
        return self.b.dtype

    @property
    def direct(self) -> bool:
        return self.sets.s1.direct

    def check(self, z, eps: float, prev=None) -> HSDECheck:
        """SCS-style residual check (HSDEStatus.jl:27-71), fully on-device.

        Replicates the reference arithmetic exactly, including its
        normalize-twice quirk: the displayed residual is
        ``||.|| / (1 + ||b||)`` while the optimality test re-multiplies the
        tolerance by ``(1 + ||b||)``.
        """
        x, y, tau, r, s, kappa = self.split(z)
        A, b, c = self.A, self.b, self.c
        nb, nc = self.norm_b, self.norm_c
        # one tile-table pass where A supports it (sparse tile ops);
        # identical to separate mv/rmv otherwise
        Ax, ATy = hsde_ops.mv_pair(A, x, y)
        # With equilibration the residual vectors are unscaled back to the
        # ORIGINAL problem (D^{-1}, E^{-1} weights); norms nb/nc are original.
        wp = self.dinv if self.dinv is not None else 1.0
        wd = self.einv if self.einv is not None else 1.0
        if self.compensated:
            # Float-float reductions (linalg/compensated.py): the duality-gap
            # numerator |c'x + b'y| is a catastrophic cancellation near
            # optimality — difference the two dots BEFORE rounding to f32.
            from fos_tpu.linalg.compensated import cdot_ff, cnorm, ff_add

            _norm = cnorm
            ctx_ff = cdot_ff(c, x)
            bty_ff = cdot_ff(b, y)
            ctx, bty = ctx_ff[0] + ctx_ff[1], bty_ff[0] + bty_ff[1]
            gap_num = ff_add(ctx_ff, bty_ff)
            gap_num = jnp.abs(gap_num[0] + gap_num[1])
        else:
            _norm = jnp.linalg.norm
            ctx = jnp.vdot(c, x)
            bty = jnp.vdot(b, y)
            gap_num = jnp.abs(ctx + bty)
        p_num = _norm(wp * (Ax / tau + s / tau - b))
        d_num = _norm(wd * (ATy / tau + c - r / tau))
        p = p_num / (1.0 + nb)
        d = d_num / (1.0 + nc)
        gden = 1.0 + jnp.abs(ctx / tau) + jnp.abs(bty / tau)
        g = (gap_num / tau) / gden

        optimal = (p <= eps * (1.0 + nb)) & (d <= eps * (1.0 + nc)) & (g <= eps * gden)
        # Certificate tests require strictly improving rays (ctx < 0 resp.
        # bty < 0): without the sign guard, an iterate that collapses to
        # z = 0 satisfies 0 <= eps*(-0/||c||) and gets falsely certified —
        # a genuine reference bug (HSDEStatus.jl:58-61) not reproduced here.
        unbounded = (ctx < 0) & (_norm(wp * (Ax + s)) <= eps * (-ctx / nc))
        if self.strict_certificates and self.K2_spec is not None:
            # Full Farkas certificate: y in K1* (guaranteed: z_check is
            # post-cone-projection) with A'y in K2* and b'y < 0 — measured
            # as the distance of A'y to K2* (consistent with the dual
            # residual A'y -> r in K2* as tau -> 0; the reference/SCS test
            # ||A'y|| ~ 0 only covers the free-variable convention).
            from fos_tpu.cones.project import project as _proj

            v = (wd * ATy) if self.dinv is not None else ATy
            cert = v - _proj(self.K2_spec.dual(), v)
            infeasible = (bty < 0) & (_norm(cert) <= eps * (-bty / nb))
        else:
            infeasible = (bty < 0) & (_norm(wd * ATy) <= eps * (-bty / nb))
        status = jnp.where(
            optimal,
            Status.OPTIMAL,
            jnp.where(
                unbounded, Status.UNBOUNDED,
                jnp.where(infeasible, Status.INFEASIBLE, Status.CONTINUE),
            ),
        ).astype(jnp.int32)
        return HSDECheck(status, p, d, g, ctx, bty, tau, kappa)


    # --- stall detection / recovery (engine hooks) -----------------------
    def gap_stalled(self, chk: HSDECheck, eps: float) -> bool:
        """True when the primal/dual residuals pass but the duality gap
        does not — the signature of the CG tolerance floor biasing the
        fixed point (an f32-path failure mode: the default floor follows
        the reference's 2l*eps formula, which is coarse at eps(f32))."""
        if int(chk.status) != Status.CONTINUE:
            return False
        nb = float(self.norm_b)
        nc = float(self.norm_c)
        tau = float(chk.tau)
        if tau <= 0:
            return False
        ctx = float(chk.ctx) / tau
        bty = float(chk.bty) / tau
        gden = 1.0 + abs(ctx) + abs(bty)
        return (float(chk.p) <= eps * (1.0 + nb)
                and float(chk.d) <= eps * (1.0 + nc)
                and float(chk.g) > eps * gden)

    def gap_stalled_traced(self, chk: HSDECheck, eps: float):
        """jit-safe twin of :meth:`gap_stalled` (a bool array, no host
        syncs) for the fused engine's on-device recovery."""
        tau = chk.tau
        safe_tau = jnp.where(tau > 0, tau, 1.0)
        ctx = chk.ctx / safe_tau
        bty = chk.bty / safe_tau
        gden = 1.0 + jnp.abs(ctx) + jnp.abs(bty)
        return ((chk.status == Status.CONTINUE)
                & (tau > 0)
                & (chk.p <= eps * (1.0 + self.norm_b))
                & (chk.d <= eps * (1.0 + self.norm_c))
                & (chk.g > eps * gden))

    def stall_score(self, chk: HSDECheck, eps: float):
        """Traced scalar "distance from passing": max over the three
        optimality tests of residual/threshold — 1.0 means exactly at the
        eps operating point.  Used by the plateau-based stall recovery
        (progress_stalled*): a run whose score stops improving check to
        check while > 1 is being held back by the CG tolerance floor
        (measured round 4: the batched lambda-min SDP plateaus at
        score~100 under the reference's loose 2l*eps floor and converges
        like f64 once tightened)."""
        tau = chk.tau
        safe_tau = jnp.where(tau > 0, tau, 1.0)
        ctx = chk.ctx / safe_tau
        bty = chk.bty / safe_tau
        gden = 1.0 + jnp.abs(ctx) + jnp.abs(bty)
        return jnp.maximum(
            chk.p / (eps * (1.0 + self.norm_b)),
            jnp.maximum(chk.d / (eps * (1.0 + self.norm_c)),
                        chk.g / (eps * gden)))

    #: plateau window: the convergence-rate test compares the stall score
    #: across this many checks
    STALL_WINDOW = 10

    def plateau_stalled_traced(self, chk: HSDECheck, eps: float, win_score,
                               remaining_checks):
        """(stalled, score): budget-aware plateau test for the fused
        engine, evaluated once per STALL_WINDOW checks.  ``win_score`` is
        the score one window ago; fire when the measured per-window
        improvement rate cannot reach score <= 1 within
        ``remaining_checks``:

            log(score) * W  >  log(rate) * remaining_checks

        This separates the two cases the simpler criteria conflated
        (round 4): a floor-limited SDP (score ~100, rate ~1.0-1.1/window
        -> needs 5-50x the remaining budget -> fire) vs a slow but
        converging refine sweep (score ~2000 but rate ~1.35/window with a
        large budget -> no fire, it makes it)."""
        score = self.stall_score(chk, eps)
        W = float(self.STALL_WINDOW)
        rate = jnp.maximum(win_score / jnp.maximum(score, 1e-30), 1.0 + 1e-6)
        cannot = (jnp.log(jnp.maximum(score, 1.0)) * W
                  > jnp.log(rate) * remaining_checks)
        stalled = ((chk.status == Status.CONTINUE)
                   & jnp.isfinite(score)          # eps=0 probes: score=inf
                   & jnp.isfinite(win_score)      # first window: baseline
                   & (score > 1.0)
                   & cannot)
        return stalled, score

    def plateau_stalled(self, chk: HSDECheck, eps: float, win_score: float,
                        remaining_checks: int):
        """Host twin of :meth:`plateau_stalled_traced` for the chunked
        engine."""
        import math as _math

        score = float(self.stall_score(chk, eps))
        if (int(chk.status) != Status.CONTINUE or not _math.isfinite(score)
                or not _math.isfinite(win_score) or score <= 1.0):
            return False, score
        rate = max(win_score / max(score, 1e-30), 1.0 + 1e-6)
        cannot = (_math.log(max(score, 1.0)) * self.STALL_WINDOW
                  > _math.log(rate) * remaining_checks)
        return cannot, score

    def fused_cg_floors(self):
        """(default_floor, tightened_floor) Python floats for the fused
        engine's on-device recovery, or None when recovery does not apply
        (direct mode, or an explicit tol_floor already at/below the
        tightened value)."""
        s1 = self.sets.s1
        if getattr(s1, "direct", False) or not hasattr(s1, "tol_floor"):
            return None
        import numpy as _np

        from fos_tpu.linalg.affine import _default_floor

        eps_dt = float(jnp.finfo(self.dtype).eps)
        tight = float(_np.sqrt(2.0 * self.l)) * eps_dt
        cur = (s1.tol_floor if s1.tol_floor is not None
               else _default_floor(2 * self.l, self.dtype))
        if cur <= tight:
            return None
        return float(cur), tight

    def tighten_cg(self):
        """Return a copy with a ~sqrt(2l)*eps CG floor (None if not
        applicable): recovers gap-stalled f32 runs — measured: a sparse LP
        Indeterminate at the default floor reaches Optimal with the same
        iteration count as the f64 path once tightened (PERF.md)."""
        s1 = self.sets.s1
        if getattr(s1, "direct", False):
            return None
        import numpy as _np

        from fos_tpu.linalg.affine import _default_floor

        eps_dt = float(jnp.finfo(self.dtype).eps)
        new_floor = float(_np.sqrt(2.0 * self.l)) * eps_dt
        cur = (s1.tol_floor if s1.tol_floor is not None
               else _default_floor(2 * self.l, self.dtype))
        if cur <= new_floor:
            return None
        s1b = HSDEAffineProjector(
            s1.A, s1.b, s1.c, s1.fac, direct=s1.direct,
            decreasing_accuracy=s1.decreasing_accuracy,
            cg_max_iters=s1.cg_max_iters, tol_floor=new_floor,
            cg_variant=s1.cg_variant, cg_unroll=s1.cg_unroll,
            compensated=s1.compensated)
        return HSDEForm(TwoSets(s1b, self.sets.s2), self.A, self.b, self.c,
                        self.norm_b, self.norm_c, self.n, self.m,
                        self.dinv, self.einv, self.K2_spec,
                        self.strict_certificates, self.compensated)

    # --- engine observability hooks (printing + history) ------------------
    def header(self, init_duration_s: float) -> str:
        from fos_tpu.utils import printing

        return printing.hsde_header(init_duration_s, self.direct)

    def _cgiter(self, st):
        if self.direct:
            return None
        return int(st.s1_state.last_iters)

    def row(self, st, chk: HSDECheck, i: int, t_s: float) -> str:
        from fos_tpu.utils import printing

        return printing.hsde_row(
            i, float(chk.p), float(chk.d), float(chk.g), float(chk.ctx),
            float(chk.bty), float(chk.kappa / chk.tau), t_s,
            cgiter=self._cgiter(st),
        )

    def record(self, hist, st, chk: HSDECheck, i: int, t_s: float, debug: int,
               extra=None):
        """History rows (HSDEStatus.jl:125-139): p,d,g,ctx,bty,kappa,tau,t;
        debug>1 additionally x,y,s.  ``extra`` is ignored: the reference's
        HSDE logextra is a deliberate no-op (HSDEStatus.jl:18-20)."""
        if hist is None or debug <= 0:
            return
        for key, val in (
            ("p", chk.p), ("d", chk.d), ("g", chk.g), ("ctx", chk.ctx),
            ("bty", chk.bty), ("kappa", chk.kappa), ("tau", chk.tau),
        ):
            hist.push(key, i, float(val))
        hist.push("t", i, t_s)
        if not self.direct:
            hist.push("cgiter", i, int(st.s1_state.last_iters))
        if debug > 1:
            x, y, tau, r, s, kappa = self.split(st.z_check)
            import numpy as np

            hist.push("x", i, np.asarray(x / tau))
            hist.push("y", i, np.asarray(y / tau))
            hist.push("s", i, np.asarray(s / tau))


class Solution(NamedTuple):
    """Recovered conic solution (types.jl:6-11).

    ``raw_z`` is the final HSDE iterate: pass it as ``initx`` to warm-start
    a subsequent solve of the same/nearby problem (the reference's ``initx``
    option, solverwrapper.jl:10, composed across solves).
    """

    x: jnp.ndarray
    y: jnp.ndarray
    s: jnp.ndarray
    status: str
    objval: float
    iters: int
    history: object = None
    raw_z: jnp.ndarray = None

    @property
    def optimal(self) -> bool:
        return self.status == "Optimal"


def populate_solution(form: HSDEForm, guess, status_code: int, iters: int,
                      history=None, raw_z=None) -> Solution:
    """(x, y, s) = (u_x, u_y, v_s) / tau; :Continue -> :Indeterminate
    (HSDE.jl:49-61)."""
    x, y, tau, r, s, kappa = form.split(guess)
    status = Status.name(status_code)
    if status == "Continue":
        status = "Indeterminate"
    if status in ("Unbounded", "Infeasible"):
        # tau = 0 at a certificate: return the RAY (unscaled) instead of the
        # reference's x/tau = Inf — the unbounded direction / Farkas
        # certificate is the useful object (SCS convention).
        tau = jnp.asarray(1.0, guess.dtype)
    xs = x / tau
    ys = y / tau
    ss = s / tau
    objval = float(jnp.vdot(form.c, xs))  # (Ec)'xh == c'x: exact either way
    if form.einv is not None:
        xs = xs / form.einv       # x = E xh
        ys = ys / form.dinv       # y = D yh
        ss = ss * form.dinv       # s = D^{-1} sh
    return Solution(
        x=xs, y=ys, s=ss, status=status,
        objval=objval, iters=iters, history=history, raw_z=raw_z,
    )
