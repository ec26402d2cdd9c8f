"""SDP: maximize the minimum eigenvalue shift — min t s.t. C + t I >= 0.

(The BASELINE.json "min-eigenvalue" SDP config.)  Optimal t* = max(0,
-lambda_min(C)) when minimizing subject to PSD, i.e. t* = -lambda_min(C)
for indefinite C.
"""

import jax

import numpy as np
import jax.numpy as jnp

from fos_tpu import DR, solve
from fos_tpu.cones import free, psd, ConeSpec
from fos_tpu.cones.spec import Cone
from fos_tpu.cones.project import svec


def main():
    rng = np.random.default_rng(4)
    d = 8
    B = rng.standard_normal((d, d))
    C = (B + B.T) / 2
    L = d * (d + 1) // 2

    # variables: (t, X in svec)  with constraint X = C + t I  (Zero rows),
    # X in PSD
    sI = np.asarray(svec(jnp.eye(d)))
    sC = np.asarray(svec(jnp.asarray(C)))
    nv = 1 + L
    A = np.zeros((L, nv))
    b = np.zeros(L)
    A[:, 0] = -sI
    A[:, 1:] = np.eye(L)
    b[:] = sC                      # X - t I = C
    c = np.zeros(nv)
    c[0] = 1.0
    K1 = ConeSpec(((Cone.ZERO, L),))
    K2 = ConeSpec(((Cone.FREE, 1), (Cone.PSD, L)))

    sol = solve(A, b, c, K1, K2, alg=DR(), eps=1e-8, max_iters=40000, verbose=0)
    t = float(sol.x[0])
    lam_min = np.linalg.eigvalsh(C).min()
    print(f"status={sol.status} t={t:.8f} -lambda_min(C)={-lam_min:.8f} "
          f"iters={sol.iters}")
    assert sol.status == "Optimal"
    assert abs(t - (-lam_min)) < 1e-5
    return sol


if __name__ == "__main__":
    main()
