"""Sparse banded LP through the blocked-ELL fast path.

A block-banded LP too big to densify comfortably still solves through the
tile operators (linalg/sparse_ell.py): scipy.sparse input flows
through the public API, the build layer picks the tile format by measured
occupancy profitability, and the solution is validated against the
constructed primal-dual certificate.

Run: python examples/sparse_banded.py  (runs on the default backend; the
demo is shrunk on the CPU)
"""


import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from fos_tpu import DR, solve
from fos_tpu.cones import nonneg


def main(m=None, half_band=40, seed=3):
    import jax

    if m is None:
        # the CPU backend is slow at the full size: shrink the demo there
        m = 4096 if jax.default_backend() != "cpu" else 1024
    rng = np.random.default_rng(seed)
    offs = list(range(-half_band, half_band + 1))
    A = sp.diags(
        [rng.standard_normal(m - abs(o)) / np.sqrt(2 * half_band + 1) for o in offs],
        offsets=offs, shape=(m, m), format="csr")
    A = A + sp.identity(m) * 2.0  # diagonal dominance: fast DR convergence

    # primal-dual certificate construction (complementary slackness)
    xmask = rng.random(m) < 0.5
    x0 = np.abs(rng.standard_normal(m)) * xmask
    r0 = np.abs(rng.standard_normal(m)) * (~xmask)
    ymask = rng.random(m) < 0.5
    y0 = np.abs(rng.standard_normal(m)) * ymask
    s0 = np.abs(rng.standard_normal(m)) * (~ymask)
    b = A @ x0 + s0
    c = r0 - A.T @ y0
    opt = float(c @ x0)

    print(f"A: {m}x{m}, nnz {A.nnz} (density {A.nnz / m**2:.2%})")
    sol = solve(A, b, c, nonneg(m), nonneg(m), alg=DR(), eps=1e-5, verbose=1,
                densify=False, sparse_format="bell", dtype=jnp.float32,
                max_iters=20000)
    print(f"status {sol.status} at {sol.iters} iterations")
    print(f"objective {sol.objval:.4f}  certificate {opt:.4f}  "
          f"rel err {abs(sol.objval - opt) / abs(opt):.2e}")
    return sol


if __name__ == "__main__":
    main()
