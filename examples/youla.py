"""Youla-parameterized FIR controller design (reference examples/youla.jl).

Discrete-time analogue of the reference's example: for a stable FIR plant
``g``, every stabilizing closed loop has sensitivity ``S = 1 - G Q`` with
free Youla parameter ``Q``; we pick an FIR Q minimizing the worst-case
step-tracking error while bounding the control effort, as a conic program:

    min  t
    s.t. ||e||_2 <= t               (SOC)          e_k = step error coeffs
         |u_k|  <= u_max            (box rows)     u = Q * step
         e = conv(1 - g*q, step) truncated

Like the reference (which builds the same problem through Convex.jl stages
and through raw ProximalOperators Feasibility), this builds the constraint
matrices by hand and solves them through the conic HSDE path.
"""

import numpy as np

from fos_tpu import DR, solve
from fos_tpu.cones import zero, nonneg, soc, ConeSpec
from fos_tpu.cones.spec import Cone


def conv_matrix(g, nq, nt):
    """T s.t. (T q)[k] = (g * q)[k] for k < nt."""
    T = np.zeros((nt, nq))
    for i, gi in enumerate(g):
        for j in range(nq):
            if i + j < nt:
                T[i + j, j] += gi
    return T


def main():
    rng = np.random.default_rng(3)
    # stable FIR plant
    g = np.array([0.0, 0.5, 0.3, 0.1, 0.05])
    nq, nt = 8, 20          # controller taps, horizon
    u_max = 2.0

    T = conv_matrix(g, nq, nt)          # y = T q (impulse response of GQ)
    L = np.tril(np.ones((nt, nt)))      # step accumulation
    # step error e = 1_step - L T q ; control u = L q_padded
    Lq = np.tril(np.ones((nt, nq)))[:, :nq]

    # variables: (q[nq], t, e[nt], u[nt])
    nv = nq + 1 + nt + nt
    rows_eq = nt + nt            # e and u definitions
    rows_soc = 1 + nt            # (t, e) in SOC
    rows_box = 2 * nt            # -u_max <= u_k <= u_max
    A = np.zeros((rows_eq + rows_soc + rows_box, nv))
    b = np.zeros(A.shape[0])
    iq, it, ie, iu = 0, nq, nq + 1, nq + 1 + nt
    r = 0
    # e + L T q = step  (e = step - LTq)
    A[r : r + nt, ie : ie + nt] = np.eye(nt)
    A[r : r + nt, iq : iq + nq] = L @ T
    b[r : r + nt] = 1.0
    r += nt
    # u - Lq q = 0
    A[r : r + nt, iu : iu + nt] = np.eye(nt)
    A[r : r + nt, iq : iq + nq] = -Lq
    r += nt
    # SOC rows: s = (t, e) in SOC  ->  s0 = t; s_k = e_k
    A[r, it] = -1.0
    A[r + 1 : r + 1 + nt, ie : ie + nt] = -np.eye(nt)
    r += 1 + nt
    # box: u_max - u_k >= 0 ; u_max + u_k >= 0
    A[r : r + nt, iu : iu + nt] = np.eye(nt)
    b[r : r + nt] = u_max
    r += nt
    A[r : r + nt, iu : iu + nt] = -np.eye(nt)
    b[r : r + nt] = u_max
    r += nt

    c = np.zeros(nv)
    c[it] = 1.0
    K1 = ConeSpec.concat([zero(rows_eq), soc(rows_soc), nonneg(rows_box)])
    K2 = ConeSpec(((Cone.FREE, nv),))

    sol = solve(A, b, c, K1, K2, alg=DR(), eps=1e-8, max_iters=60000, verbose=0)
    q = np.asarray(sol.x[:nq])
    e = np.asarray(sol.x[ie : ie + nt])
    u = np.asarray(sol.x[iu : iu + nt])
    print(f"status={sol.status} ||e||={np.linalg.norm(e):.6f} "
          f"max|u|={np.abs(u).max():.4f} (bound {u_max}) iters={sol.iters}")
    assert sol.status == "Optimal"
    assert np.abs(u).max() <= u_max + 1e-6
    # oracle: SLSQP on the same QP-in-q
    from scipy.optimize import minimize

    def obj(qv):
        ev = 1.0 - L @ T @ qv
        return float(ev @ ev)

    cons = []
    for k in range(nt):
        cons.append({"type": "ineq", "fun": (lambda qv, k=k: u_max - (Lq @ qv)[k])})
        cons.append({"type": "ineq", "fun": (lambda qv, k=k: u_max + (Lq @ qv)[k])})
    res = minimize(obj, np.zeros(nq), constraints=cons, method="SLSQP",
                   options={"maxiter": 1000, "ftol": 1e-14})
    print(f"SLSQP oracle ||e||: {np.sqrt(res.fun):.6f}")
    assert np.linalg.norm(e) <= np.sqrt(res.fun) + 1e-4
    return sol


if __name__ == "__main__":
    main()
