#!/usr/bin/env python
"""Smoke test of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # only the mesh phase, on 4 cards

Each phase drives the public entry points (``fos_tpu.solve``,
``fused_solve``, ``solve_batched``, ``project``) at full size and checks
the result against a plain reference: the primal-dual certificate a
problem was built from, numpy/scipy in f64, ``eigvalsh``, or the same
computation on the CPU backend.  One line per phase gives its compile
time, run time and numbers; a failed check marks the phase FAILED and the
script exits 1 after the remaining phases.  Without a GPU it exits 1 at
once.  The last line of a passing run is the JSON device record
``{"ok": true, "device": {...}}``.

Matmul precision: the solver pins ``Precision.HIGHEST`` (full f32, no
TF32) on its products; the tolerances below assume it.

Objective tolerances: a solve stopped at eps=1e-5 is not exact.  On the
1000x1000 LP the eps band admits about 2e-3 of objective play (an f64
run on the CPU stops 2.1e-3 from the certificate), so dense-LP
objectives are checked to ``EPS_BAND`` = 5e-3 of their certificates and
to 1e-3 of each other; problems whose stop points sit closer keep 1e-3.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# problem sizes (a rehearsal may shrink them; the contract run uses these)
SIZE = {"dense_lp": 4000,      # lp_4000 side (64 MB of f32 A)
        "band_nrb": 256,       # 128-row blocks of the banded LP (1e7 nnz)
        "batch": 1024,         # solve_batched instances of 64x96
        "sdp_d": 512,          # PSD block side
        "rows_lp": 16000}      # row-sharded dense LP side (1 GB of f32 A)
_FUSED = {}
EPS_BAND = 5e-3   # objective play admitted by eps=1e-5 (module docstring)

COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]
FAILED = []


def _on_event(event, duration, **_):
    if event in COMPILE_EVENTS:
        _compile_s[0] += duration


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase(name, fn):
    """Run one phase; print its compile/run time and results or FAILED."""
    import traceback

    c0 = _compile_s[0]
    t0 = time.perf_counter()
    try:
        out = fn()
        status = "ok"
    except Exception as e:  # noqa: BLE001 - recorded, exits 1 at the end
        traceback.print_exc()
        out = {"error": f"{type(e).__name__}: {e}"[:500]}
        status = "FAILED"
        FAILED.append(name)
    wall = time.perf_counter() - t0
    comp = _compile_s[0] - c0
    print(f"phase {name} {status} compile_s={comp:.1f} "
          f"run_s={wall - comp:.1f} " + json.dumps(out, default=float),
          flush=True)


# -- problems -------------------------------------------------------------

def certificate_lps(key, B, m, n):
    """B random LPs min c'x s.t. Ax + s = b, s >= 0, x >= 0 built from a
    complementary primal-dual pair, generated on device (f32).  Returns
    (A, b, c, opt) with opt = c'x0, the optimal objective."""
    import jax
    import jax.numpy as jnp

    ka, kx, kr, ky, ks, kmx, kmy = jax.random.split(key, 7)
    A = jax.random.normal(ka, (B, m, n), jnp.float32) / float(n) ** 0.5
    xm = jax.random.bernoulli(kmx, 0.5, (B, n))
    ym = jax.random.bernoulli(kmy, 0.5, (B, m))
    x0 = jnp.where(xm, jnp.abs(jax.random.normal(kx, (B, n), jnp.float32)), 0.)
    r0 = jnp.where(xm, 0., jnp.abs(jax.random.normal(kr, (B, n), jnp.float32)))
    y0 = jnp.where(ym, jnp.abs(jax.random.normal(ky, (B, m), jnp.float32)), 0.)
    s0 = jnp.where(ym, 0., jnp.abs(jax.random.normal(ks, (B, m), jnp.float32)))
    hi = jax.lax.Precision.HIGHEST
    b = jnp.einsum("bmn,bn->bm", A, x0, precision=hi) + s0
    c = r0 - jnp.einsum("bmn,bm->bn", A, y0, precision=hi)
    return A, b, c, jnp.sum(c * x0, axis=1)


def fused(alg, form, max_iters, eps, **kw):
    import jax

    from fos_tpu.solvers.engine import fused_solve

    key = (repr(alg), max_iters, tuple(sorted(kw.items())))
    if key not in _FUSED:
        _FUSED[key] = jax.jit(lambda f, x, e: fused_solve(
            alg, f, x, max_iters=max_iters, eps=e, checki=100, **kw))
    res = _FUSED[key](form, form.initial_value(form.dtype), eps)
    jax.block_until_ready(res.guess)
    return res


def objective(form, guess):
    import jax.numpy as jnp

    n, l = form.n, form.l
    return float(jnp.vdot(form.c, guess[:n]) / guess[l - 1])


# -- phases ----------------------------------------------------------------

def phase_device(dev):
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("nvidia-smi: " + " | ".join(smi.strip().splitlines()), flush=True)
    return {"kind": dev.device_kind, "count": len(jax.devices()),
            "jax": jax.__version__}


def phase_lp_1e6():
    """The bench's 1000x1000 dense LP: f64 ``solve`` and f32
    ``fused_solve`` to Optimal, objectives within EPS_BAND of c@x0 and
    within rel 1e-3 of each other."""
    import numpy as np
    import jax.numpy as jnp

    import bench
    from fos_tpu import DR, solve
    from fos_tpu.cones import nonneg
    from fos_tpu.problems.conic import conic_problem
    from fos_tpu.problems.hsde import HSDEForm

    A, b, c, opt = bench.make_problem(np.float64)
    t0 = time.perf_counter()
    sol = solve(A, b, c, nonneg(bench.M), nonneg(bench.N), alg=DR(),
                eps=1e-5, verbose=0)
    t64 = time.perf_counter() - t0
    check(sol.status == "Optimal", f"f64 solve status {sol.status}")
    check(rel(sol.objval, opt) < EPS_BAND, f"f64 obj {sol.objval} vs {opt}")
    prob = conic_problem(jnp.asarray(A, jnp.float32),
                         jnp.asarray(b, jnp.float32),
                         jnp.asarray(c, jnp.float32),
                         nonneg(bench.M), nonneg(bench.N))
    form = HSDEForm.build(prob)
    res = fused(DR(), form, 10000, 1e-5)
    obj32 = objective(form, res.guess)
    check(int(res.status) == 1, f"f32 fused status {int(res.status)}")
    check(rel(obj32, opt) < EPS_BAND, f"f32 obj {obj32} vs {opt}")
    check(rel(obj32, sol.objval) < 1e-3, f"f32 {obj32} vs f64 {sol.objval}")
    return {"opt": opt, "f64": {"obj": sol.objval, "iters": sol.iters,
                                "wall_s": t64,
                                "rel_err": rel(sol.objval, opt)},
            "f32_fused": {"obj": obj32, "iters": int(res.iters),
                          "rel_err": rel(obj32, opt)}}


def phase_lp_4000():
    """4000x4000 f32 dense LP generated on device: ``fused_solve`` for a
    fixed 300-iteration budget (finite iterate), and ``q_mul`` against
    numpy f64 on the same data to rel 1e-5 (TF32 would miss it by ~100x)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from fos_tpu import DR
    from fos_tpu.cones import nonneg
    from fos_tpu.linalg import hsde_ops
    from fos_tpu.problems.conic import conic_problem
    from fos_tpu.problems.hsde import HSDEForm

    mn = SIZE["dense_lp"]
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(11), 4)
    A = jax.random.normal(k1, (mn, mn), jnp.float32) / float(np.sqrt(mn))
    b = A @ jnp.abs(jax.random.normal(k2, (mn,), jnp.float32))
    c = jnp.abs(jax.random.normal(k3, (mn,), jnp.float32))
    form = HSDEForm.build(conic_problem(A, b, c, nonneg(mn), nonneg(mn)))
    fused(DR(), form, 300, 0.0)                      # compile + warm
    t0 = time.perf_counter()
    res = fused(DR(), form, 300, 0.0)
    dt = time.perf_counter() - t0
    check(bool(jnp.all(jnp.isfinite(res.guess))), "non-finite iterate")
    z = jax.random.normal(k4, (2 * mn + 1,), jnp.float32)
    y = np.asarray(jax.jit(hsde_ops.q_mul)(A, b, c, z), np.float64)
    A64, b64, c64, z64 = (np.asarray(v, np.float64) for v in (A, b, c, z))
    x1, x2, x3 = z64[:mn], z64[mn:2 * mn], z64[2 * mn]
    ref = np.concatenate([A64.T @ x2 + c64 * x3, -A64 @ x1 + b64 * x3,
                          [-c64 @ x1 - b64 @ x2]])
    err = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
    check(err < 1e-5, f"q_mul rel err {err}")
    return {"iters_per_s_300": 300 / dt, "qmul_rel_err_vs_f64": err}


def _bsr_of(op):
    """scipy f64 BSR matrix of a BlockedEllOp's tile table."""
    import numpy as np
    import scipy.sparse as sp

    blocks = np.asarray(op.blocks, np.float64)
    nrb, K, bm, bn = blocks.shape
    cols = np.asarray(op.cols).reshape(-1)
    indptr = np.arange(0, nrb * K + 1, K)
    return sp.bsr_matrix((blocks.reshape(-1, bm, bn), cols, indptr),
                         shape=(nrb * bm, op.blocks_t.shape[0] * bn))


def phase_sparse_band_1e7():
    """The 1e7-nnz block-tridiagonal LP (32768^2, 48 MiB tile table):
    mv / rmv / mv_pair of both tile layouts against scipy f64 on the same
    tiles (rel 1e-5 of the largest entry), the compiled banded pair
    kernel against the plain pair, and ``fused_solve`` to Optimal at
    eps=1e-5 with each layout, objective within rel 1e-3 of c@x0."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    import bench
    from fos_tpu import DR
    from fos_tpu.cones import nonneg
    from fos_tpu.linalg import sparse_ell as se
    from fos_tpu.problems.conic import ConicProblem
    from fos_tpu.problems.hsde import HSDEForm

    op, op_band, b, c, opt, nnz = bench._banded_bell_problem(nrb=SIZE["band_nrb"])
    S = _bsr_of(op)
    kx, kz = jax.random.split(jax.random.PRNGKey(5))
    x = jax.random.normal(kx, (op.n,), jnp.float32)
    z = jax.random.normal(kz, (op.m,), jnp.float32)
    x64, z64 = np.asarray(x, np.float64), np.asarray(z, np.float64)
    rx, rz = S @ x64, S.T @ z64
    errs = {}
    for name, o in (("ell", op), ("band", op_band)):
        y1, y2 = jax.jit(lambda o, x, z: o.mv_pair(x, z))(o, x, z)
        for k, got, ref in (("mv", jax.jit(lambda o, x: o.mv(x))(o, x), rx),
                            ("rmv", jax.jit(lambda o, z: o.rmv(z))(o, z), rz),
                            ("pair_y1", y1, rx), ("pair_y2", y2, rz)):
            e = float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                      / np.max(np.abs(ref)))
            errs[f"{name}_{k}"] = e
            check(e < 1e-5, f"{name} {k} rel err {e}")
    cs, blocks, xb = op_band._mv_args(x)
    zb = z.reshape(blocks.shape[0], -1)
    kernel = se.use_band_pair_kernel(jax.default_backend(), blocks.shape,
                                     blocks.dtype)
    check(kernel, "banded pair kernel not selected on the GPU")
    t1, t2 = jax.jit(se._band_mv_pair_triton)(cs, blocks, xb, zb)
    p1, p2 = jax.jit(se._band_mv_pair_xla)(cs, blocks, xb, zb)
    e_k = max(float(jnp.max(jnp.abs(t1 - p1)) / jnp.max(jnp.abs(p1))),
              float(jnp.max(jnp.abs(t2 - p2)) / jnp.max(jnp.abs(p2))))
    errs["pair_kernel_vs_plain"] = e_k
    check(e_k < 1e-5, f"pair kernel vs plain rel err {e_k}")
    out = {"nnz": nnz, "table_mib": blocks.size * 4 / 2**20,
           "rel_err": errs, "opt": opt}
    for name, o in (("band", op_band), ("ell", op)):
        form = HSDEForm.build(ConicProblem(o, b, c, nonneg(op.m),
                                           nonneg(op.n)), densify=False)
        t0 = time.perf_counter()
        res = fused(DR(), form, 6000, 1e-5)
        dt = time.perf_counter() - t0
        obj = objective(form, res.guess)
        check(int(res.status) == 1, f"{name} status {int(res.status)}")
        check(rel(obj, opt) < 1e-3, f"{name} obj {obj} vs {opt}")
        out[name] = {"obj": obj, "iters": int(res.iters), "wall_s": dt}
    return out


def phase_batched():
    """1024 certificate LPs of 64x96 through ``solve_batched``: all
    Optimal at eps=1e-5, objectives within EPS_BAND of c@x0 (relative to
    max(|c@x0|, 1))."""
    import numpy as np
    import jax

    from fos_tpu import DR
    from fos_tpu.cones import nonneg
    from fos_tpu.parallel import build_batched_form, solve_batched

    B, m, n = SIZE["batch"], 64, 96
    A, b, c, opt = certificate_lps(jax.random.PRNGKey(17), B, m, n)
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n))
    t0 = time.perf_counter()
    res = solve_batched(DR(), form, max_iters=20000, eps=1e-5, checki=100)
    jax.block_until_ready(res.guess)
    dt = time.perf_counter() - t0
    l = n + m + 1
    obj = np.asarray(jax.vmap(lambda g, cc: cc @ g[:n] / g[l - 1])(
        res.guess, c))
    opt = np.asarray(opt)
    status = np.asarray(res.status)
    err = np.abs(obj - opt) / np.maximum(np.abs(opt), 1.0)
    check(bool(np.all(status == 1)), f"{int(np.sum(status != 1))} not Optimal")
    check(float(err.max()) < EPS_BAND, f"max rel obj err {float(err.max())}")
    return {"instances": B, "max_iters": int(np.max(np.asarray(res.iters))),
            "max_rel_obj_err": float(err.max()), "wall_s": dt}


def phase_sdp():
    """d=512 PSD projection with poly and eigh against numpy f64 eigh
    (max abs error within 1e-4 of the largest entry, f32), and the d=512
    lambda-min SDP (GAPA) to Optimal within rel 1e-3 of eigvalsh."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    import bench
    from fos_tpu import GAPA, ConeSpec, project
    from fos_tpu.cones import psd
    from fos_tpu.cones.project import smat, svec

    d = SIZE["sdp_d"]
    G = jax.random.normal(jax.random.PRNGKey(3), (d, d), jnp.float32)
    X = (G + G.T) / float(2 * np.sqrt(d))
    w, V = np.linalg.eigh(np.asarray(X, np.float64))
    ref = (V * np.maximum(w, 0)) @ V.T
    spec = psd(d)
    out = {}
    for method in ("poly", "eigh"):
        f = jax.jit(lambda v, m=method: project(spec, v, psd_method=m))
        P = np.asarray(smat(f(svec(X))), np.float64)
        e = float(np.max(np.abs(P - ref)) / np.max(np.abs(ref)))
        out[f"proj_{method}_rel_err"] = e
        check(e < 1e-4, f"{method} projection rel err {e}")
    form, C, sC = bench.sdp_single_problem(d)
    res = fused(GAPA(0.8, 0.9), form, 8000, 1e-5)
    obj = float(jnp.vdot(sC, res.guess[:sC.shape[0]]) / res.guess[form.l - 1])
    lam = float(np.linalg.eigvalsh(np.asarray(C, np.float64))[0])
    check(int(res.status) == 1, f"sdp status {int(res.status)}")
    check(abs(obj - lam) / (1 + abs(lam)) < 1e-3, f"sdp obj {obj} vs {lam}")
    out.update({"sdp_obj": obj, "lam_min_f64": lam, "iters": int(res.iters)})
    return out


MIXED_BLOCKS = ("zero", "nonneg", "soc", "rotated_soc", "psd", "exp", "pow")


def mixed_projection(psd_method):
    """f64 projection of 4096 random vectors onto one mixed cone product
    (zero, nonneg, SOC, rotated SOC, PSD, exp, pow) on the default
    backend: (input, projection, block boundaries) as numpy arrays."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from fos_tpu import ConeSpec, project
    from fos_tpu.cones import (exp_primal, nonneg, pow_primal, psd,
                               rotated_soc, soc, zero)

    parts = [zero(3), nonneg(5), soc(6), rotated_soc(5), psd(4),
             exp_primal(2), pow_primal([0.3, 0.7])]
    spec = ConeSpec.concat(parts)
    # host-made input: the same bits on every backend
    x = np.random.default_rng(7).standard_normal((4096, spec.dim))
    y = jax.jit(lambda v: project(spec, v, psd_method=psd_method))(
        jnp.asarray(x, jnp.float64))
    return x, np.asarray(y), np.cumsum([0] + [p.dim for p in parts])


def phase_cones():
    """:func:`mixed_projection` on the card against the same projection
    under the CPU backend in a child process, so that this process keeps
    the card to itself: both PSD methods, f64, max abs difference within
    1e-8 per cone family."""
    import io

    import numpy as np

    out = {}
    for method in ("eigh", "poly"):
        _, y_gpu, bounds = mixed_projection(method)
        cpu = subprocess.run(
            [sys.executable, "-c", "import sys, numpy, chip_smoke; numpy.savez("
             "sys.stdout.buffer, *chip_smoke.mixed_projection(sys.argv[1]))",
             method], env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT,
            capture_output=True, timeout=600)
        check(cpu.returncode == 0, "CPU child failed: "
              + cpu.stderr.decode()[-300:])
        npz = np.load(io.BytesIO(cpu.stdout))
        y_cpu = npz["arr_1"]
        diff = {name: float(np.max(np.abs(y_gpu[:, lo:hi] - y_cpu[:, lo:hi])))
                for name, lo, hi in zip(MIXED_BLOCKS, bounds[:-1], bounds[1:])}
        out[method] = diff
        bad = {k: v for k, v in diff.items() if not v < 1e-8}
        check(not bad, f"{method}: gpu vs cpu max abs diff {bad}")
    out["dim"], out["vectors"] = int(y_gpu.shape[1]), int(y_gpu.shape[0])
    return out


def _batch_objectives(res, c, n, m):
    import numpy as np
    import jax

    l = n + m + 1
    return np.asarray(jax.vmap(lambda g, cc: cc @ g[:n] / g[l - 1])(
        res.guess, c))


def _four_batch(devs, one):
    """1024 certificate LPs sharded over ``batch`` on 4 cards against one
    card: all Optimal on both, objectives within EPS_BAND of the
    certificates and of each other (f32 runs compiled for one and for four
    cards sum in different orders, so stop points move inside the eps
    band)."""
    import numpy as np
    import jax

    from fos_tpu import DR
    from fos_tpu.cones import nonneg
    from fos_tpu.parallel import (build_batched_form, make_mesh,
                                  shard_batched_form, solve_batched)

    B, m, n = SIZE["batch"], 64, 96
    A, b, c, opt = certificate_lps(jax.random.PRNGKey(17), B, m, n)
    form = build_batched_form(A, b, c, nonneg(m), nonneg(n))
    opt = np.asarray(opt)
    scale = np.maximum(np.abs(opt), 1.0)
    out, objs, stats = {}, {}, {}
    for name, f in (("one", jax.device_put(form, one)),
                    ("four", shard_batched_form(
                        form, make_mesh((len(devs),), ("batch",))))):
        solve = lambda: solve_batched(DR(), f, max_iters=20000, eps=1e-5,
                                      checki=100)
        jax.block_until_ready(solve().guess)          # compile + warm
        t0 = time.perf_counter()
        r = solve()
        jax.block_until_ready(r.guess)
        out[f"wall_s_{name}"] = time.perf_counter() - t0
        out[f"max_iters_{name}"] = int(np.max(np.asarray(r.iters)))
        objs[name] = _batch_objectives(r, c, n, m)
        stats[name] = np.asarray(r.status)
        err = float(np.max(np.abs(objs[name] - opt) / scale))
        out[f"max_rel_obj_err_{name}"] = err
        check(bool(np.all(stats[name] == 1)), f"{name}: not all Optimal")
        check(err < EPS_BAND, f"{name}: max rel obj err {err}")
    d = float(np.max(np.abs(objs["one"] - objs["four"]) / scale))
    out["max_rel_obj_diff_one_vs_four"] = d
    check(d < EPS_BAND, f"one vs four objectives differ by {d}")
    return out


def _four_rows(devs):
    """A 16000x16000 f32 dense LP row-sharded over 4 cards against one
    card: one ``q_mul`` within rel 1e-5 (the sharded arithmetic itself),
    and 200 fused iterations each with iterates within rel 1e-2 (f32 runs
    summing in different orders stop their inner CG at different points,
    so trajectories drift apart by about the CG tolerance)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from fos_tpu import DR
    from fos_tpu.cones import nonneg
    from fos_tpu.linalg import hsde_ops
    from fos_tpu.parallel import make_mesh, shard_problem_rows
    from fos_tpu.problems.conic import conic_problem
    from fos_tpu.problems.hsde import HSDEForm

    mn = SIZE["rows_lp"]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(23), 3)
    A = jax.random.normal(k1, (mn, mn), jnp.float32) / float(np.sqrt(mn))
    bb = A @ jnp.abs(jax.random.normal(k2, (mn,), jnp.float32))
    cc = jnp.abs(jax.random.normal(k3, (mn,), jnp.float32))
    form = HSDEForm.build(conic_problem(A, bb, cc, nonneg(mn), nonneg(mn)))
    del A
    out, guess, qz = {}, {}, {}
    z = jax.random.normal(jax.random.PRNGKey(29), (2 * mn + 1,), jnp.float32)
    for name, f in (("one", form),
                    ("four", shard_problem_rows(
                        form, make_mesh((1, len(devs)),
                                        ("batch", "model"))))):
        qz[name] = np.asarray(jax.jit(hsde_ops.q_mul)(f.A, f.b, f.c, z))
        fused(DR(), f, 200, 0.0)                     # compile + warm
        t0 = time.perf_counter()
        r = fused(DR(), f, 200, 0.0)
        out[f"iters_per_s_{name}"] = 200 / (time.perf_counter() - t0)
        guess[name] = np.asarray(r.guess)
    dq = float(np.max(np.abs(qz["one"] - qz["four"]))
               / np.max(np.abs(qz["one"])))
    d = float(np.max(np.abs(guess["one"] - guess["four"]))
              / np.max(np.abs(guess["one"])))
    out.update(qmul_rel_diff=dq, rel_iterate_diff=d)
    check(dq < 1e-5, f"row-sharded q_mul rel diff {dq}")
    check(d < 1e-2, f"row-sharded iterate rel diff {d}")
    return out


def _four_band(devs):
    """RowShardedOp over the 1e7-nnz banded operator on 4 cards against
    the one-card operator: the pair within rel 1e-5, and the fused-solve
    rate of each."""
    import jax
    import jax.numpy as jnp

    import bench
    from fos_tpu import DR
    from fos_tpu.cones import nonneg
    from fos_tpu.parallel import RowShardedOp, make_mesh
    from fos_tpu.problems.conic import ConicProblem
    from fos_tpu.problems.hsde import HSDEForm

    op, op_band, b, c, opt, nnz = bench._banded_bell_problem(
        nrb=SIZE["band_nrb"])
    sop = RowShardedOp.create(
        op_band, make_mesh((1, len(devs)), ("batch", "model")), "model")
    kx, kz = jax.random.split(jax.random.PRNGKey(5))
    x = jax.random.normal(kx, (op.n,), jnp.float32)
    z = jax.random.normal(kz, (op.m,), jnp.float32)
    pair = jax.jit(lambda o, x, z: o.mv_pair(x, z))
    l1, l2 = pair(op_band, x, z)
    s1, s2 = pair(sop, x, z)
    e = max(float(jnp.max(jnp.abs(l1 - s1)) / jnp.max(jnp.abs(l1))),
            float(jnp.max(jnp.abs(l2 - s2)) / jnp.max(jnp.abs(l2))))
    out = {"pair_rel_err": e}
    for name, o in (("one", op_band), ("four", sop)):
        f = HSDEForm.build(ConicProblem(o, b, c, nonneg(op.m), nonneg(op.n)),
                           densify=False)
        fused(DR(), f, 300, 0.0)
        t0 = time.perf_counter()
        fused(DR(), f, 300, 0.0)
        out[f"iters_per_s_{name}"] = 300 / (time.perf_counter() - t0)
    check(e < 1e-5, f"RowShardedOp pair rel err {e}")
    return out


def phase_four_cards():
    """The mesh path on 4 cards against one card (see :func:`_four_batch`,
    :func:`_four_rows`, :func:`_four_band`).  Every part runs; the phase
    fails if any part did."""
    import jax

    devs = jax.devices()
    check(len(devs) == 4, f"{len(devs)} devices, need 4")
    one = jax.sharding.SingleDeviceSharding(devs[0])
    out, errors = {}, []
    for name, fn in (("batch", lambda: _four_batch(devs, one)),
                     ("rows", lambda: _four_rows(devs)),
                     ("band", lambda: _four_band(devs))):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 - re-raised below
            out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
            errors.append(name)
    print("four_cards parts: " + json.dumps(out, default=float), flush=True)
    check(not errors, f"failed parts {errors}: "
          + "; ".join(out[k]["error"] for k in errors))
    return out


def main(argv):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (default device is {dev.platform})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from fos_tpu.config import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: fos_tpu not importable: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    phase("device", lambda: phase_device(dev))
    if "--four-cards" in argv:
        phase("four_cards", phase_four_cards)
    else:
        for name, fn in (("lp_1e6", phase_lp_1e6),
                         ("lp_4000", phase_lp_4000),
                         ("sparse_band_1e7", phase_sparse_band_1e7),
                         ("batched", phase_batched),
                         ("sdp", phase_sdp),
                         ("cones", phase_cones)):
            phase(name, fn)
    if FAILED:
        print(f"chip_smoke: failed phases: {FAILED}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
