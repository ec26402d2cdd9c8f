"""Native (C++) host-runtime components, loaded via ctypes.

The compute path of fos_tpu is jax/XLA/Pallas; this package holds the
*host-side* native tier — currently the sparse tile packer
(:mod:`packer.cpp`) that turns COO triplets into the 128x128 tile tables
consumed by the tile operators.  The shared library is
compiled on first use with ``g++`` and cached next to the source, keyed
on a hash of the source text so edits rebuild automatically.  Every
entry point degrades gracefully: if the toolchain is missing or the
compile/load fails, callers fall back to the pure-numpy packers in
:mod:`fos_tpu.linalg.sparse_ell` (bit-identical results — pinned by
tests/test_native.py).

Set ``FOS_TPU_NO_NATIVE=1`` to force the numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "packer.cpp")

_lock = threading.Lock()
_lib = None
_load_attempted = False
_load_error: str | None = None


def _compile_and_load():
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:12]
    soname = f"_packer-{tag}.so"

    candidates = [os.path.join(_HERE, soname),
                  os.path.join(tempfile.gettempdir(), f"fos_tpu-{soname}")]
    last_err = None
    for path in candidates:
        if os.path.exists(path):
            try:
                return ctypes.CDLL(path)
            except OSError as e:
                # corrupt / wrong-platform cached binary: drop it and fall
                # through to a fresh compile instead of disabling native
                last_err = e
                try:
                    os.unlink(path)
                except OSError:
                    pass

    for path in candidates:
        # best-effort cleanup of artifacts from superseded source hashes
        for old in _stale_artifacts(os.path.dirname(path), soname):
            try:
                os.unlink(old)
            except OSError:
                pass
        tmp = path + f".build-{os.getpid()}"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-o", tmp, _SRC, "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)  # atomic vs concurrent builders
            return ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as e:
            last_err = e
            try:
                os.unlink(tmp)
            except OSError:
                pass
    raise RuntimeError(f"native packer build failed: {last_err}")


def _stale_artifacts(dirpath, current_soname):
    try:
        names = os.listdir(dirpath)
    except OSError:
        return
    for name in names:
        if (name.startswith(("_packer-", "fos_tpu-_packer-"))
                and name.endswith(".so") and not name.endswith(current_soname)):
            yield os.path.join(dirpath, name)


def _declare(lib):
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32i = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p32f = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.fos_ell_phase1.restype = i64
    lib.fos_ell_phase1.argtypes = [p64, p64, i64, i64, i64, i64, i64,
                                   p64, p64, p32i, p64]
    lib.fos_ell_fill.restype = None
    lib.fos_ell_fill.argtypes = [p64, p64, p32f, p64, p64, p32i,
                                 i64, i64, i64, i64, p32f, p32i]
    lib.fos_band_phase1.restype = i64
    lib.fos_band_phase1.argtypes = [p64, p64, i64, i64, i64, i64, i64, p64]
    lib.fos_band_fill.restype = None
    lib.fos_band_fill.argtypes = [p64, p64, p32f, i64, i64, i64, i64,
                                  p64, p32f]
    return lib


def get():
    """The loaded native library, or None (toolchain missing, compile
    failed, or FOS_TPU_NO_NATIVE=1)."""
    global _lib, _load_attempted, _load_error
    if os.environ.get("FOS_TPU_NO_NATIVE"):
        return None
    if _load_attempted:
        return _lib
    with _lock:
        if not _load_attempted:
            try:
                _lib = _declare(_compile_and_load())
            except Exception as e:  # noqa: BLE001 - any failure => fallback
                _load_error = f"{type(e).__name__}: {e}"
                _lib = None
            _load_attempted = True
    return _lib


def load_error() -> str | None:
    """Why the native library is unavailable (None if loaded / not tried)."""
    return _load_error


def _as_c(rows, cols, vals):
    r = np.ascontiguousarray(rows, np.int64)
    c = np.ascontiguousarray(cols, np.int64)
    v = np.ascontiguousarray(vals, np.float32)
    return r, c, v


def ell_pack(rows, cols, vals, nrb, ncb, bm, bn, kmax_of):
    """Native blocked-ELL pack; returns (blocks, cols_tab, counts) or None.

    ``kmax_of(max_count)`` maps the max per-block tile count to the padded
    kmax (the caller owns the padding policy so numpy and native paths
    cannot drift).
    """
    lib = get()
    if lib is None:
        return None
    r, c, v = _as_c(rows, cols, vals)
    nnz = r.size
    perm = np.empty(max(nnz, 1), np.int64)
    offs = np.empty(nrb + 1, np.int64)
    slot = np.empty(max(nnz, 1), np.int32)
    counts = np.empty(nrb, np.int64)
    maxc = lib.fos_ell_phase1(r, c, nnz, bm, bn, nrb, ncb,
                              perm, offs, slot, counts)
    if maxc < 0:
        return None  # out-of-grid entry: let the numpy path raise naturally
    kmax = kmax_of(int(maxc))
    blocks = np.zeros((nrb, kmax, bm, bn), np.float32)
    cols_tab = np.zeros((nrb, kmax), np.int32)
    lib.fos_ell_fill(r, c, v, perm, offs, slot, nrb, bm, bn, kmax,
                     blocks, cols_tab)
    return blocks, cols_tab, counts


def band_pack(rows, cols, vals, nrb, ncb, bm, bn):
    """Native banded-block pack; returns (blocks, lo, S) or None."""
    lib = get()
    if lib is None:
        return None
    r, c, v = _as_c(rows, cols, vals)
    nnz = r.size
    lo = np.empty(nrb, np.int64)
    S = lib.fos_band_phase1(r, c, nnz, bm, bn, nrb, ncb, lo)
    if S < 0:
        return None
    blocks = np.zeros((nrb, int(S), bm, bn), np.float32)
    lib.fos_band_fill(r, c, v, nnz, bm, bn, S, lo, blocks)
    return blocks, lo.astype(np.int32), int(S)
