#!/usr/bin/env python
"""Races behind the GPU path choices, timed on the device in one process.

    python tools/kernel_races.py [--only NAME[,NAME...]] [--out DIR]

Sections (each prints ``race <name> ...`` lines and adds to one JSON file,
``DIR/races.json``, DIR defaulting to ``races_out/`` in the checkout):

* ``band_pair``: the banded ``(A @ x, A' @ z)`` pair on the 1e7-nnz
  block-tridiagonal LP — the Pallas (Triton) kernel against the plain
  two-contraction form: agreement, time per pair, and the end-to-end
  ``fused_solve`` iterations/s with each, in turns.
* ``formats``: ``fused_solve`` iterations/s of the same LP as banded tiles,
  blocked-ELL tiles, BCOO and dense A, and of a 2000x2000 5%-density LP as
  BCOO, ELL, banded and dense — the numbers behind ``sparse_format="auto"``.
* ``psd``: poly against ``eigh`` PSD projection at d=512, d=1024 and a
  batch of 64 blocks of 64x64: time per projection and max error against a
  numpy f64 eigendecomposition — the numbers behind ``resolve_psd_method``.
* ``dense_qmul``: one dense 4000x4000 f32 ``q_mul``: time, the kernels a
  profiler trace shows per call, and the bytes each reads — whether A is
  read once or twice.

Needs a GPU; prints the card's name and power limit first.  ``--small``
runs every section at toy sizes on any backend (the kernel in interpret
mode off the GPU) to rehearse the script.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

OUT = {}
SMALL = "--small" in sys.argv
NRB = 8 if SMALL else 256          # banded LP: 256 row blocks = 1e7 nnz
N5 = 300 if SMALL else 2000        # uniform 5%-density LP side
MN = 512 if SMALL else 4000        # dense q_mul side
OUT_DIR = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
           else os.path.join(ROOT, "races_out"))


def log(name, **kv):
    OUT.setdefault(name, []).append(kv)
    print(f"race {name} " + json.dumps(kv), flush=True)


def times(fn, *args, reps=5):
    """Compile + warm once, then ``reps`` wall times (s), each ending in
    block_until_ready."""
    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def med(v):
    return sorted(v)[len(v) // 2]


def solve_rate(form, iters=300, unroll=1, reps=3):
    """fused_solve iterations/s at eps=0 (runs exactly ``iters``)."""
    from fos_tpu import DR
    from fos_tpu.solvers.engine import fused_solve

    run = jax.jit(lambda f, x: fused_solve(
        DR(), f, x, max_iters=iters, eps=0.0, checki=100, unroll=unroll))
    x0 = form.initial_value(form.dtype)
    ts = times(run, form, x0, reps=reps)
    r = run(form, x0)
    kbar = (float(r.state.s1_state.total_iters)
            / max(float(r.state.s1_state.call_idx) - 1.0, 1.0))
    return [iters / t for t in ts], kbar


def pair_chain(pair, reps):
    """jit of ``reps`` data-dependent pairs; the tables are arguments (a
    closure would embed them in the executable as constants)."""
    def run(cs, blocks, x, z):
        def body(_, carry):
            x, z = carry
            y1, y2 = pair(cs, blocks, x, z)
            return (y2 / (jnp.max(jnp.abs(y2)) + 1.0),
                    y1 / (jnp.max(jnp.abs(y1)) + 1.0))
        return jax.lax.fori_loop(0, reps, body, (x, z))
    return jax.jit(run)


def race_band_pair():
    import bench
    from fos_tpu.cones import nonneg
    from fos_tpu.linalg import sparse_ell as se
    from fos_tpu.problems.conic import ConicProblem
    from fos_tpu.problems.hsde import HSDEForm

    op, op_band, b, c, opt, nnz = bench._banded_bell_problem(nrb=NRB)
    cs, blocks, xb = op_band._mv_args(jax.random.normal(
        jax.random.PRNGKey(1), (op.n,), jnp.float32))
    zb = jax.random.normal(jax.random.PRNGKey(2), (blocks.shape[0], 128),
                           jnp.float32)
    tri = jax.jit(se._band_mv_pair_triton)
    if jax.default_backend() != "gpu":
        import functools

        se._band_mv_pair_triton = functools.partial(
            se._band_mv_pair_triton, interpret=True)
        tri = jax.jit(se._band_mv_pair_triton)
    xla = jax.jit(se._band_mv_pair_xla)
    t1, t2 = tri(cs, blocks, xb, zb)
    p1, p2 = xla(cs, blocks, xb, zb)
    log("band_pair", check="agreement",
        y1_max_abs=float(jnp.max(jnp.abs(t1 - p1))),
        y2_max_abs=float(jnp.max(jnp.abs(t2 - p2))),
        y1_scale=float(jnp.max(jnp.abs(p1))),
        table_bytes=int(blocks.size * 4))

    for name, pair in (("triton", se._band_mv_pair_triton),
                       ("xla", se._band_mv_pair_xla)) * 2:
        ts = times(pair_chain(pair, 200), cs, blocks, xb, zb)
        per = med(ts) / 200
        log("band_pair", impl=name, us_per_pair=per * 1e6,
            table_gbps=blocks.size * 4 / per / 1e9)

    prob = ConicProblem(op_band, b, c, nonneg(op.m), nonneg(op.n))
    orig = se.use_band_pair_kernel
    for name in ("triton", "xla", "xla", "triton"):
        se.use_band_pair_kernel = (orig if name == "triton"
                                   else (lambda *a: False))
        try:
            form = HSDEForm.build(prob, densify=False)
            rates, kbar = solve_rate(form)
        finally:
            se.use_band_pair_kernel = orig
        log("band_pair", impl=name, e2e_iters_per_s=rates, kbar=kbar)


def race_band_sweep():
    """Pair time, kernel against plain, over row-block count and window
    width (random tables): where the kernel's (nrb, 2) grid is too small
    to fill the card, the plain form wins."""
    from fos_tpu.linalg import sparse_ell as se

    for S in (3, 16):
        for nrb in ((4, 8) if SMALL else (16, 32, 64, 128, 256, 512)):
            k = jax.random.split(jax.random.PRNGKey(nrb * 100 + S), 3)
            blocks = jax.random.normal(k[0], (nrb, S, 128, 128), jnp.float32)
            cs = jnp.clip(jnp.arange(nrb) - 1, 0, nrb - 1).astype(jnp.int32)
            xb = jax.random.normal(k[1], (nrb + S, 128), jnp.float32)
            zb = jax.random.normal(k[2], (nrb, 128), jnp.float32)
            row = {"S": S, "nrb": nrb}
            for name, pair in (("triton", se._band_mv_pair_triton),
                               ("xla", se._band_mv_pair_xla)):
                f = pair_chain(pair, 100)
                row[f"{name}_us"] = med(times(f, cs, blocks, xb, zb)) / 100 * 1e6
            log("band_sweep", **row)


def _banded_as(op, fmt):
    """The ELL tiles of ``op`` as BCOO or dense A (built on device)."""
    from jax.experimental.sparse import BCOO

    nrb, K, bm, bn = op.blocks.shape
    if fmt == "dense":
        ncb = op.blocks_t.shape[0]
        d4 = jnp.zeros((nrb, ncb, bm, bn), jnp.float32)
        d4 = d4.at[jnp.arange(nrb)[:, None], op.cols].add(op.blocks)
        return d4.transpose(0, 2, 1, 3).reshape(nrb * bm, ncb * bn)
    r = (jnp.arange(nrb)[:, None, None, None] * bm
         + jnp.arange(bm)[None, None, :, None])
    cidx = op.cols[:, :, None, None] * bn + jnp.arange(bn)[None, None, None]
    r, cidx = jnp.broadcast_arrays(r, cidx)
    keep = np.asarray(op.blocks != 0).reshape(-1)
    idx = jnp.stack([r.reshape(-1), cidx.reshape(-1)], 1)[keep]
    return BCOO((op.blocks.reshape(-1)[keep], idx), shape=op.shape)


def race_formats():
    import scipy.sparse as sp

    import bench
    from fos_tpu.cones import nonneg
    from fos_tpu.problems.conic import ConicProblem, conic_problem
    from fos_tpu.problems.hsde import HSDEForm

    op, op_band, b, c, opt, nnz = bench._banded_bell_problem(nrb=NRB)
    for name in ("band", "ell", "bcoo", "dense"):
        A = {"band": op_band, "ell": op}.get(name) or _banded_as(op, name)
        prob = ConicProblem(A, b, c, nonneg(op.m), nonneg(op.n))
        form = HSDEForm.build(prob, densify=False, sparse_format="bcoo")
        rates, kbar = solve_rate(form)
        log("formats", problem="banded_1e7", fmt=name,
            a_type=type(form.A).__name__, iters_per_s=rates, kbar=kbar)
        del A, prob, form

    Asp = sp.random(N5, N5, density=0.05,
                    random_state=np.random.RandomState(23), format="csr")
    rng = np.random.default_rng(23)
    b5 = (Asp @ np.abs(rng.standard_normal(N5))).astype(np.float32)
    c5 = np.abs(rng.standard_normal(N5)).astype(np.float32)
    from fos_tpu.linalg.sparse_ell import BlockedEllOp

    A5 = Asp.astype(np.float32)
    for name, kw in (("bcoo", dict(densify=False, sparse_format="bcoo")),
                     ("ell", dict(densify=False)),
                     ("band", dict(densify=False, sparse_format="band")),
                     ("dense", dict(densify=True, sparse_format="bcoo"))):
        A = (BlockedEllOp.create(A5, transpose_table=False) if name == "ell"
             else A5)
        prob = conic_problem(A, jnp.asarray(b5), jnp.asarray(c5),
                             nonneg(N5), nonneg(N5))
        form = HSDEForm.build(prob, **kw)
        rates, kbar = solve_rate(form)
        log("formats", problem="uniform_5pct_2000", fmt=name,
            a_type=type(form.A).__name__, iters_per_s=rates, kbar=kbar)


def race_psd():
    from fos_tpu.cones.project import psd_project_eigh
    from fos_tpu.cones.psd_poly import psd_project_poly

    shapes = ((512, 512), (1024, 1024), (64, 64, 64))
    for shape in (((64, 64), (4, 32, 32)) if SMALL else shapes):
        G = jax.random.normal(jax.random.PRNGKey(3), shape, jnp.float32)
        X = (G + jnp.swapaxes(G, -1, -2)) / float(2 * np.sqrt(shape[-1]))
        X64 = np.asarray(X, np.float64)
        w, V = np.linalg.eigh(X64)
        ref = (V * np.maximum(w, 0)[..., None, :]) @ np.swapaxes(V, -1, -2)
        for name, fn in (("poly", psd_project_poly),
                         ("eigh", psd_project_eigh)) * 2:
            f = jax.jit(fn)
            ts = times(f, X, reps=10)
            err = float(np.max(np.abs(np.asarray(f(X), np.float64) - ref)))
            log("psd", shape=list(shape), method=name, ms=med(ts) * 1e3,
                ms_min=min(ts) * 1e3, max_abs_err=err,
                max_abs_x=float(np.max(np.abs(X64))))


def race_dense_qmul():
    from fos_tpu.linalg import hsde_ops

    mn = MN
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    A = jax.random.normal(k1, (mn, mn), jnp.float32) / float(np.sqrt(mn))
    b = jax.random.normal(k2, (mn,), jnp.float32)
    c = jax.random.normal(k3, (mn,), jnp.float32)
    z = jnp.ones(2 * mn + 1, jnp.float32)
    q = jax.jit(hsde_ops.q_mul)
    hlo = q.lower(A, b, c, z).compile().as_text()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "qmul_hlo.txt"), "w") as f:
        f.write(hlo)
    entry = hlo[hlo.index("ENTRY"):]
    ops = [ln.strip()[:200] for ln in entry.splitlines()
           if "=" in ln and ("fusion" in ln or "custom-call" in ln)]
    log("dense_qmul", entry_kernels=len(ops), ops=ops[:10])

    reps = 200

    def run(A, b, c, z):
        def body(_, z):
            y = hsde_ops.q_mul(A, b, c, z)
            return y / (jnp.max(jnp.abs(y)) + 1.0)
        return jax.lax.fori_loop(0, reps, body, z)

    chain = jax.jit(run)
    with open(os.path.join(OUT_DIR, "qmul_chain_hlo.txt"),
              "w") as f:
        f.write(chain.lower(A, b, c, z).compile().as_text())
    ts = times(chain, A, b, c, z)
    per = med(ts) / reps
    log("dense_qmul", us_per_qmul=per * 1e6,
        gbps_if_one_read=A.size * 4 / per / 1e9,
        gbps_if_two_reads=2 * A.size * 4 / per / 1e9)

    tdir = os.path.join(OUT_DIR, "trace_qmul")
    jax.profiler.start_trace(tdir)
    jax.block_until_ready(chain(A, b, c, z))
    jax.profiler.stop_trace()
    from jax.profiler import ProfileData

    path = None
    for dp, _, fs in os.walk(tdir):
        for f in fs:
            if f.endswith(".xplane.pb"):
                path = os.path.join(dp, f)
    pd = ProfileData.from_file(path)
    agg = {}
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                k = (line.name, ev.name)
                n, d = agg.get(k, (0, 0.0))
                agg[k] = (n + 1, d + ev.duration_ns)
    top = sorted(agg.items(), key=lambda kv: -kv[1][1])[:12]
    for (ln, name), (n, d) in top:
        log("dense_qmul", trace_line=ln, kernel=name[:100], count=n,
            us_per_call=d / n / 1e3, us_per_qmul=d / reps / 1e3)


RACES = {"band_pair": race_band_pair, "band_sweep": race_band_sweep,
         "formats": race_formats,
         "psd": race_psd, "dense_qmul": race_dense_qmul}


def main():
    only = None
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not SMALL:
        print(f"no GPU (default device: {dev.platform})", file=sys.stderr)
        return 1
    from fos_tpu.config import enable_compile_cache

    enable_compile_cache()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
    except OSError as e:
        smi = f"nvidia-smi unavailable: {e}"
    OUT["device"] = {"nvidia_smi": smi.strip(), "kind": dev.device_kind,
                     "count": len(jax.devices()), "jax": jax.__version__}
    print("device", json.dumps(OUT["device"]), flush=True)
    rc = 0
    for name, fn in RACES.items():
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - report and run the rest
            import traceback

            traceback.print_exc()
            log(name, error=f"{type(e).__name__}: {e}"[:400])
            rc = 1
        print(f"section {name} {time.perf_counter() - t0:.1f}s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "races.json"), "w") as f:
        json.dump(OUT, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
