"""Native C++ tile packer vs the pure-numpy reference packers.

The native path (fos_tpu/native/packer.cpp) must produce bit-identical
tables to the numpy implementations in sparse_ell.py — same tile order
(sorted block-columns), same duplicate-COO summing, same padding."""

import math

import numpy as np
import pytest
import scipy.sparse as sp

from fos_tpu import native
from fos_tpu.linalg import sparse_ell
from fos_tpu.linalg.sparse_ell import (BandedBlockOp, BlockedEllOp,
                                       _build_band_arrays, _build_ell_arrays)


def _numpy_only(monkeypatch):
    monkeypatch.setattr(native, "ell_pack",
                        lambda *a, **k: None)
    monkeypatch.setattr(native, "band_pack",
                        lambda *a, **k: None)


def _cases(rng):
    yield "banded", sp.diags(
        [np.ones(500), 2.0 * np.ones(512), np.ones(308)],
        offsets=[-12, 0, 212], shape=(512, 520), format="csr",
    ).astype(np.float32)
    yield "random", sp.random(700, 330, density=0.01, format="csr",
                              random_state=3, dtype=np.float32)
    yield "empty", sp.csr_matrix((200, 400), dtype=np.float32)
    yield "tall-sliver", sp.random(2000, 40, density=0.05, format="csr",
                                   random_state=4, dtype=np.float32)
    # duplicate COO entries must SUM identically (same stable order)
    r = np.array([0, 0, 5, 129, 129, 129, 300], np.int64)
    c = np.array([3, 3, 200, 7, 7, 7, 410], np.int64)
    v = np.array([1.0, 2.5, -1.0, 0.1, 0.2, 0.4, 9.0], np.float32)
    yield "dups", sp.coo_matrix((v, (r, c)), shape=(512, 512))


@pytest.mark.skipif(native.get() is None,
                    reason=f"native packer unavailable: {native.load_error()}")
def test_native_matches_numpy_ell_and_band(monkeypatch, rng):
    for name, A in _cases(rng):
        coo = A.tocoo()
        rows = np.asarray(coo.row, np.int64)
        cols = np.asarray(coo.col, np.int64)
        vals = np.asarray(coo.data, np.float32)
        m, n = A.shape
        for (mm, nn, rr, cc) in ((m, n, rows, cols), (n, m, cols, rows)):
            for bm, bn in ((128, 128), (128, 256)):
                nrb = math.ceil(mm / bm)
                ncb = math.ceil(nn / bn)
                nat = native.ell_pack(rr, cc, vals, nrb, ncb, bm, bn,
                                      sparse_ell._ell_kmax)
                assert nat is not None
                with monkeypatch.context() as mp:
                    _numpy_only(mp)
                    ref = _build_ell_arrays(mm, nn, rr, cc, vals, bm, bn)
                for a, b in zip(nat, ref):
                    np.testing.assert_array_equal(a, b, err_msg=name)

                natb = native.band_pack(rr, cc, vals, nrb, ncb, bm, bn)
                assert natb is not None
                with monkeypatch.context() as mp:
                    _numpy_only(mp)
                    refb = _build_band_arrays(mm, nn, rr, cc, vals, bm, bn)
                np.testing.assert_array_equal(natb[0], refb[0], err_msg=name)
                np.testing.assert_array_equal(natb[1], refb[1], err_msg=name)
                assert natb[2] == refb[2], name


@pytest.mark.skipif(native.get() is None,
                    reason=f"native packer unavailable: {native.load_error()}")
def test_ops_built_native_agree_with_scipy(rng):
    A = sp.random(900, 700, density=0.02, format="csr", random_state=7,
                  dtype=np.float32)
    x = rng.standard_normal(700).astype(np.float32)
    y = rng.standard_normal(900).astype(np.float32)
    for cls in (BlockedEllOp, BandedBlockOp):
        op = cls.create(A)
        np.testing.assert_allclose(np.asarray(op.mv(x)), A @ x, atol=2e-4)
        np.testing.assert_allclose(np.asarray(op.rmv(y)), A.T @ y, atol=2e-4)


@pytest.mark.skipif(native.get() is None,
                    reason=f"native packer unavailable: {native.load_error()}")
def test_out_of_grid_entries_reject():
    """Negative / too-large indices must return None (fall back to numpy,
    which raises on them) — C++ truncating division would otherwise let
    rows in (-bm, 0) alias block 0 and scatter out of bounds."""
    vals = np.ones(1, np.float32)
    for r, c in ((-1, 3), (3, -1), (10**6, 3), (3, 10**6)):
        rows = np.array([r], np.int64)
        cols = np.array([c], np.int64)
        assert native.ell_pack(rows, cols, vals, 8, 4, 128, 128,
                               sparse_ell._ell_kmax) is None
        assert native.band_pack(rows, cols, vals, 8, 4, 128, 128) is None


def test_fallback_when_disabled(monkeypatch):
    """FOS_TPU_NO_NATIVE=1 forces get() -> None and the numpy path."""
    monkeypatch.setenv("FOS_TPU_NO_NATIVE", "1")
    assert native.get() is None
    A = sp.random(300, 300, density=0.02, format="csr", random_state=1,
                  dtype=np.float32)
    op = BlockedEllOp.create(A)
    x = np.ones(300, np.float32)
    np.testing.assert_allclose(np.asarray(op.mv(x)), A @ x, atol=2e-4)
