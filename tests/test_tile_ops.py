"""Tile operators on the plain path, the banded pair kernel and the choices
around them: the kernel rule, the auto-densify gate, the compile cache
helper, and chip_smoke.py's refusal to run without a GPU.

The banded pair kernel is a Pallas (Triton) kernel: here it runs in
interpret mode against the plain two-contraction pair; the compiled kernel
is checked by the ``gpu``-marked test below and by chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.experimental.sparse import BCOO

from fos_tpu import config
from fos_tpu.cones import nonneg
from fos_tpu.linalg import sparse_ell as se
from fos_tpu.problems.conic import conic_problem
from fos_tpu.problems.hsde import HSDEForm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _banded(m, n, bw, seed):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(m):
        ci = i * n // m                     # band follows the diagonal
        lo, hi = max(0, ci - bw), min(n, ci + bw + 1)
        k = rng.integers(1, 4)
        rows += [i] * k
        cols += rng.integers(lo, hi, k).tolist()
    vals = rng.standard_normal(len(rows))
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


def _empty_rows():
    # whole 128-row blocks with no entry, non-multiple-of-128 shape
    return sp.csr_matrix((np.array([1.0, -2.0, 0.5]),
                          ([5, 200, 399], [7, 0, 250])), shape=(400, 300))


def _duplicates():
    # COO duplicates sum (BCOO semantics)
    r = np.array([0, 0, 3, 130, 130, 130])
    c = np.array([1, 1, 2, 140, 140, 5])
    v = np.array([1.0, 2.0, -1.0, 0.5, 0.25, 3.0])
    return sp.coo_matrix((v, (r, c)), shape=(200, 260))


CASES = {
    "banded_700x900": lambda: _banded(700, 900, 60, 1),
    "banded_tall_1100x300": lambda: _banded(1100, 300, 40, 2),
    "empty_rows_400x300": _empty_rows,
    "duplicates_200x260": _duplicates,
    # uniform 3% on 1300^2: every tile occupied -> window S = 11 > 8
    "wide_window_1300": lambda: sp.random(
        1300, 1300, density=0.03, random_state=np.random.RandomState(4),
        format="csr"),
}


@pytest.mark.parametrize("layout", [se.BlockedEllOp, se.BandedBlockOp],
                         ids=["ell", "band"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_ops_match_scipy(case, layout):
    A = CASES[case]().astype(np.float32)
    op = layout.create(A)
    if case == "wide_window_1300" and layout is se.BandedBlockOp:
        assert op.blocks.shape[1] > 8
    m, n = A.shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    z = rng.standard_normal(m).astype(np.float32)
    A64 = A.astype(np.float64)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(x))), A64 @ x,
                               **tol)
    np.testing.assert_allclose(np.asarray(op.rmv(jnp.asarray(z))),
                               A64.T @ z, **tol)
    y1, y2 = jax.jit(lambda o, x, z: o.mv_pair(x, z))(
        op, jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(np.asarray(y1), A64 @ x, **tol)
    np.testing.assert_allclose(np.asarray(y2), A64.T @ z, **tol)


def _pair_args(A):
    op = se.BandedBlockOp.create(A.astype(np.float32),
                                 transpose_table=False)
    m, n = A.shape
    rng = np.random.default_rng(3)
    cs, blocks, xb = op._mv_args(jnp.asarray(rng.standard_normal(n),
                                             jnp.float32))
    nrb, _, bm, _ = blocks.shape
    z = jnp.asarray(rng.standard_normal(nrb * bm), jnp.float32)
    return cs, blocks, xb, z.reshape(nrb, bm)


@pytest.mark.parametrize("case", ["banded_700x900", "wide_window_1300",
                                  "empty_rows_400x300"])
def test_band_pair_kernel_interpret_matches_plain(case):
    cs, blocks, xb, zb = _pair_args(CASES[case]())
    k1, k2 = se._band_mv_pair_triton(cs, blocks, xb, zb, interpret=True)
    p1, p2 = se._band_mv_pair_xla(cs, blocks, xb, zb)
    assert k1.shape == p1.shape and k2.shape == p2.shape
    np.testing.assert_allclose(np.asarray(k1), np.asarray(p1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(k2), np.asarray(p2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("platform,shape,dtype,expect", [
    ("gpu", (256, 3, 128, 128), jnp.float32, True),
    ("gpu", (64, 16, 64, 256), jnp.float32, True),
    ("gpu", (63, 3, 128, 128), jnp.float32, False),  # grid too small
    ("cpu", (256, 3, 128, 128), jnp.float32, False),
    ("gpu", (256, 3, 128, 128), jnp.float64, False),
    ("gpu", (256, 3, 96, 128), jnp.float32, False),  # half-tile not 2^k
    ("gpu", (256, 3, 128, 100), jnp.float32, False),
])
def test_band_pair_kernel_rule(platform, shape, dtype, expect):
    assert se.use_band_pair_kernel(platform, shape, dtype) is expect


@pytest.mark.gpu
def test_band_pair_kernel_compiled_on_gpu(gpu):
    """The compiled kernel at the 1e7-nnz banded LP's table shape against
    the plain pair (chip_smoke.py's sparse phase runs the same check)."""
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    nrb, S = 256, 3
    blocks = jax.random.normal(k[0], (nrb, S, 128, 128), jnp.float32)
    cs = jnp.clip(jnp.arange(nrb) - 1, 0, nrb - S).astype(jnp.int32)
    xb = jax.random.normal(k[1], (nrb + S, 128), jnp.float32)
    zb = jax.random.normal(k[2], (nrb, 128), jnp.float32)
    k1, k2 = jax.jit(se._band_mv_pair_triton)(cs, blocks, xb, zb)
    p1, p2 = jax.jit(se._band_mv_pair_xla)(cs, blocks, xb, zb)
    np.testing.assert_allclose(np.asarray(k1), np.asarray(p1),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(k2), np.asarray(p2),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dense_bytes,limit,expect", [
    (4 * 2**30, 60 * 2**30, True),     # 4 GiB dense A, 60 GiB card
    (16 * 2**30, 60 * 2**30, False),   # over a quarter
    (15 * 2**30, 60 * 2**30, False),   # exactly a quarter is not under
    (2**20, None, False),              # no limit reported (CPU)
    (2**20, 0, False),
])
def test_densify_gate(dense_bytes, limit, expect):
    assert config.densify_fits(dense_bytes, limit) is expect


def _uniform_lp(n=256):
    A = sp.random(n, n, density=0.05, random_state=np.random.RandomState(5),
                  format="csr").astype(np.float32)
    return conic_problem(A, jnp.ones(n, jnp.float32),
                         jnp.ones(n, jnp.float32), nonneg(n), nonneg(n))


@pytest.mark.parametrize("limit,dense", [(2**30, True), (None, False)])
def test_auto_densify_follows_device_memory(monkeypatch, limit, dense):
    # every tile occupied -> no tile layout; densify iff the dense copy
    # fits a quarter of the device limit
    monkeypatch.setattr(config, "device_bytes_limit", lambda: limit)
    form = HSDEForm.build(_uniform_lp())
    assert isinstance(form.A, BCOO) is not dense


def test_tile_layout_precedes_densify(monkeypatch):
    # a banded f32 A takes the tile path even when the dense copy fits
    monkeypatch.setattr(config, "device_bytes_limit", lambda: 2**40)
    A = _banded(4096, 4096, 150, 6).astype(np.float32)
    prob = conic_problem(A, jnp.ones(4096, jnp.float32),
                         jnp.ones(4096, jnp.float32), nonneg(4096),
                         nonneg(4096))
    assert isinstance(HSDEForm.build(prob).A, se.BandedBlockOp)
    # densify=True still forces the dense copy
    assert not hasattr(HSDEForm.build(prob, densify=True).A, "mv")


@pytest.fixture
def _cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_dir(monkeypatch, _cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_var_wins(monkeypatch, _cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert config.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.mark.parametrize("backend,asked,expect", [
    ("gpu", "auto", "poly"), ("cpu", "auto", "eigh"), ("rocm", "auto", "eigh"),
    ("gpu", "eigh", "eigh"), ("cpu", "poly", "poly"),
])
def test_psd_method_rule(monkeypatch, backend, asked, expect):
    from fos_tpu.cones.project import resolve_psd_method

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_psd_method(asked) == expect
