"""Tiled sparse matrix operators: blocked-ELL and banded-block layouts.

The reference treats sparse A as a first-class citizen via Julia's
``SparseMatrixCSC`` matvecs (HSDEAffine.jl:41-59, tested at 0.001 density in
test/HSDEAffine.jl:84-90).  Densifying a very large A runs out of device
memory, and an unstructured gather/scatter SpMV (what BCOO lowers to)
reads the matrix element by element.  This module is the middle path:

* A is tiled into (bm, bn) = (128, 128) dense tiles; only tiles containing
  nonzeros are stored, in ELL layout — ``blocks[i, k]`` is the k-th
  occupied tile of block-row i and ``cols[i, k]`` its block-column.
* ``mv`` gathers the x blocks each stored tile needs and runs one batched
  tile-times-vector contraction, so the bytes read are proportional to the
  number of OCCUPIED tiles, not to the dense size.
* ``rmv`` uses a second ELL built from A' (sparse tiles of A and A' differ;
  storing both costs 2x occupied tiles, still far below dense).
* ``mv_pair`` returns ``(A @ x, A' @ z)`` from the A table alone — the shape
  the HSDE ``q_mul`` consumes.  For the banded layout on the GPU it is one
  Pallas kernel that reads each tile once for both products.

Cost model: speed and storage are ``occupancy``x dense, where occupancy is
the fraction of 128x128 tiles containing any nonzero.  Block-structured /
banded problems (the realistic conic case) win proportionally; a uniformly
random matrix at density >= ~1e-3 fills every tile and degenerates to the
dense path (use BCOO or densify there — ``occupancy()`` reports the ratio
so the build layer can choose).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

# f32 contractions at full f32 precision: on the GPU an f32 einsum may
# otherwise run in TF32 (about three decimal digits)
_HI = jax.lax.Precision.HIGHEST


def _bell_mv(cols, blocks, xb):
    """y[i] = sum_k blocks[i, k] @ xb[cols[i, k]].

    cols: (nrb, K) int32; blocks: (nrb, K, bm, bn); xb: (ncb, bn) ->
    (nrb, bm).  Padding slots hold zero tiles, so whatever block they
    index contributes nothing."""
    return jnp.einsum("ikrc,ikc->ir", blocks, xb[cols], precision=_HI)


def _tile_rows_sum(cols, p, nrows):
    """Sum per-tile rows ``p[i, k]`` (nrb, K, bn) into block row
    ``cols[i, k]`` of an (nrows, bn) result."""
    bn = p.shape[-1]
    return jax.ops.segment_sum(p.reshape(-1, bn), cols.reshape(-1),
                               num_segments=nrows)


def _bell_mv_pair(cols, blocks, xb, zb):
    """(A @ x, A' @ z) from the A table: y1 as :func:`_bell_mv`; each tile
    contributes ``blocks[i, k]' z[i]`` to block row ``cols[i, k]`` of y2.
    zb: (nrb, bm) -> (y1: (nrb, bm), y2: (xb.shape[0], bn))."""
    y1 = _bell_mv(cols, blocks, xb)
    p = jnp.einsum("ikrc,ir->ikc", blocks, zb, precision=_HI)
    return y1, _tile_rows_sum(cols, p, xb.shape[0])


def _band_cols(cs, S):
    """Block-column of each window slot: cs[i] + s for s < S."""
    return cs[:, None] + jnp.arange(S, dtype=cs.dtype)[None, :]


def _band_mv(cs, blocks, xb):
    """cs: (nrb,) int32 first block-column of each row block's window;
    blocks: (nrb, S, bm, bn); xb: (ncb + S, bn) padded so every window
    stays in range -> y: (nrb, bm)."""
    return _bell_mv(_band_cols(cs, blocks.shape[1]), blocks, xb)


# -- banded pair kernel (Pallas, Triton route) ----------------------------
#
# One program per (row block i, half h of its bm rows).  It walks the S
# tiles of its window, loading each (bm/2, bn) half-tile once and using it
# twice: the row sums against x give its half of y1 directly; the column
# sums against z give that half-tile's share of A'z, written to a partials
# array (nrb, 2, S, bn) that XLA then sums into y2.  No program writes
# where another does, so there are no atomics and no cross-block order.
# Products are elementwise multiplies plus reductions in f32 (no matrix
# unit, so no TF32).


def _band_pair_kernel(cs_ref, a_ref, x_ref, z_ref, y1_ref, p_ref,
                      *, S, bm, bn, hm):
    i = pl.program_id(0)
    h = pl.program_id(1)
    c0 = cs_ref[i]
    row0 = i * bm + h * hm
    z = z_ref[pl.ds(row0, hm)]                              # (hm,)

    def body(s, acc):
        a = a_ref[pl.ds((i * S + s) * bm + h * hm, hm), :]  # (hm, bn)
        x = x_ref[pl.ds((c0 + s) * bn, bn)]                 # (bn,)
        p_ref[pl.ds(((i * 2 + h) * S + s) * bn, bn)] = jnp.sum(
            a * z[:, None], axis=0)
        return acc + jnp.sum(a * x[None, :], axis=1)

    y1_ref[pl.ds(row0, hm)] = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(S), body, jnp.zeros((hm,), jnp.float32))


def _band_mv_pair_triton(cs, blocks, xb, zb, *, interpret=False):
    """Kernel form of :func:`_band_mv_pair_xla` (same arguments and
    results).  ``interpret=True`` runs it on the CPU for tests."""
    from jax.experimental.pallas import triton as plgpu

    nrb, S, bm, bn = blocks.shape
    hm = bm // 2
    y1, parts = pl.pallas_call(
        functools.partial(_band_pair_kernel, S=S, bm=bm, bn=bn, hm=hm),
        grid=(nrb, 2),
        out_shape=[jax.ShapeDtypeStruct((nrb * bm,), jnp.float32),
                   jax.ShapeDtypeStruct((nrb * 2 * S * bn,), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="band_mv_pair",
    )(cs.astype(jnp.int32), blocks.reshape(nrb * S * bm, bn),
      xb.reshape(-1), zb.reshape(-1))
    p = parts.reshape(nrb, 2, S, bn).sum(axis=1)
    return (y1.reshape(nrb, bm),
            _tile_rows_sum(_band_cols(cs, S), p, xb.shape[0]))


def _band_mv_pair_xla(cs, blocks, xb, zb):
    """cs: (nrb,) int32; blocks: (nrb, S, bm, bn); xb: (ncb + S, bn)
    padded; zb: (nrb, bm) -> (y1: (nrb, bm) = A x, y2: (ncb + S, bn) =
    A' z), as two contractions over the same table."""
    return _bell_mv_pair(_band_cols(cs, blocks.shape[1]), blocks, xb, zb)


def _is_pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


#: the kernel's grid is (row blocks, 2); below this many row blocks it
#: leaves most of the card idle and the plain form is as fast or faster
#: (H100 sweep over 16..512 row blocks at S = 3 and 16, PERF.md)
KERNEL_MIN_ROW_BLOCKS = 64


def use_band_pair_kernel(platform: str, blocks_shape, dtype) -> bool:
    """The banded pair runs as the Pallas kernel on the GPU, for f32 tiles
    whose halves and rows are power-of-two sized (Triton's block rule) and
    at least :data:`KERNEL_MIN_ROW_BLOCKS` row blocks; everywhere else it
    is the plain two-contraction form."""
    nrb, _, bm, bn = blocks_shape
    return (platform == "gpu" and jnp.dtype(dtype) == jnp.float32
            and nrb >= KERNEL_MIN_ROW_BLOCKS
            and bm >= 2 and _is_pow2(bm) and _is_pow2(bn))


def _band_mv_pair(cs, blocks, xb, zb):
    if use_band_pair_kernel(jax.default_backend(), blocks.shape,
                            blocks.dtype):
        return _band_mv_pair_triton(cs, blocks, xb, zb)
    return _band_mv_pair_xla(cs, blocks, xb, zb)


def _ell_kmax(max_count: int) -> int:
    """Tile-slot count per block row (at least 1).  Shared by the numpy and
    native packers (passed as ``kmax_of``) so the policy cannot drift
    between them."""
    return max(max_count, 1)


def _build_ell_arrays(m, n, rows, cols, vals, bm, bn):
    """Pack COO triplets into blocked-ELL numpy arrays (host, build-time).

    Tries the native C++ packer (fos_tpu/native/packer.cpp — fused
    counting-sort + dedup + scatter, threaded; ~6x end-to-end at 1e7 nnz,
    the rest is zeroing/touching the tile tables — PERF.md) and falls back
    to the numpy implementation below; both produce bit-identical tables
    (tests/test_native.py)."""
    nrb = math.ceil(m / bm)
    ncb = math.ceil(n / bn)
    from fos_tpu import native

    nat = native.ell_pack(rows, cols, vals, nrb, ncb, bm, bn, _ell_kmax)
    if nat is not None:
        return nat
    ti = rows // bm
    tj = cols // bn
    pair = ti.astype(np.int64) * ncb + tj
    upair, inv = np.unique(pair, return_inverse=True)
    uti = (upair // ncb).astype(np.int64)
    utj = (upair % ncb).astype(np.int64)
    # slot index of each occupied tile within its block-row (tiles arrive
    # sorted by (ti, tj) from np.unique)
    counts = np.bincount(uti, minlength=nrb)
    kmax = _ell_kmax(int(counts.max()) if counts.size else 0)
    row_start = np.zeros(nrb + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    slot = np.arange(upair.size) - row_start[uti]

    blocks = np.zeros((nrb, kmax, bm, bn), np.float32)
    cols_tab = np.zeros((nrb, kmax), np.int32)
    cols_tab[uti, slot] = utj.astype(np.int32)
    # np.add.at: duplicate COO indices SUM (BCOO semantics; fancy
    # assignment would silently keep only the last duplicate)
    np.add.at(blocks, (uti[inv], slot[inv], rows - ti * bm, cols - tj * bn),
              vals)
    return blocks, cols_tab, counts


def _build_band_arrays(m, n, rows, cols, vals, bm, bn):
    """Pack COO triplets into banded-block numpy arrays: per row block a
    contiguous column window [cs_i, cs_i + S) holds all its tiles (S = max
    window over row blocks; sparse-within-window slots stay zero).

    Tries the native C++ packer first (see _build_ell_arrays)."""
    nrb = math.ceil(m / bm)
    from fos_tpu import native

    nat = native.band_pack(rows, cols, vals, nrb, math.ceil(n / bn), bm, bn)
    if nat is not None:
        return nat
    ti = rows // bm
    tj = cols // bn
    lo = np.full(nrb, np.iinfo(np.int64).max, np.int64)
    hi = np.full(nrb, -1, np.int64)
    if rows.size:
        np.minimum.at(lo, ti, tj)
        np.maximum.at(hi, ti, tj)
    lo = np.where(hi >= 0, lo, 0)
    S = max(int((hi - lo + 1).max()) if rows.size else 1, 1)
    blocks = np.zeros((nrb, S, bm, bn), np.float32)
    if rows.size:
        # duplicates SUM (BCOO semantics), as in _build_ell_arrays
        np.add.at(blocks, (ti, tj - lo[ti], rows - ti * bm, cols - tj * bn),
                  vals)
    return blocks, lo.astype(np.int32), S


def tridiag_band_layout(blocks):
    """Convert block-tridiagonal ELL slots ``[low, diag, up]`` (cols
    ``clip(i-1..i+1)``, edge tiles zeroed) to the banded layout: slots
    line up with windows ``cs_i = clip(i - 1, 0, nrb - 3)`` — the first
    row shifts left, the last shifts right.  Used by the device-side
    problem builders (bench.py, chip_smoke.py)."""
    blk = blocks.at[0].set(jnp.roll(blocks[0], -1, axis=0).at[2].set(0.0))
    blk = blk.at[-1].set(jnp.roll(blocks[-1], 1, axis=0).at[0].set(0.0))
    nrb = blocks.shape[0]
    cs = np.clip(np.arange(nrb) - 1, 0, nrb - 3).astype(np.int32)
    return blk, jnp.asarray(cs)


def band_span_ratio(A, bm=128, bn=128) -> float:
    """Banded-block storage (both layouts) relative to blocked-ELL storage
    — 1.0 when every row/col block's occupied tiles are contiguous (banded
    matrices), large when columns are scattered across the row."""
    rows, cols, _, m, n = _coo_parts(A)
    if rows.size == 0:
        return 1.0

    def one(r, c, mm, br, bc):
        nrb = math.ceil(mm / br)
        ti = r // br
        tj = c // bc
        lo = np.full(nrb, np.iinfo(np.int64).max, np.int64)
        hi = np.full(nrb, -1, np.int64)
        np.minimum.at(lo, ti, tj)
        np.maximum.at(hi, ti, tj)
        span = int(np.where(hi >= 0, hi - lo + 1, 0).max())
        ncb_tiles = int(tj.max()) + 1
        upair = np.unique(ti.astype(np.int64) * ncb_tiles + tj)
        cnt = int(np.bincount(upair // ncb_tiles, minlength=nrb).max())
        return span / max(cnt, 1)

    # the transpose layout blocks rows by bn and columns by bm
    return max(one(rows, cols, m, bm, bn), one(cols, rows, n, bn, bm))


@jax.tree_util.register_pytree_node_class
class BandedBlockOp:
    """Banded-block sparse operator: same mv/rmv/shape/todense protocol as
    :class:`BlockedEllOp`, but each row block's tiles occupy a contiguous
    block-column window, so x is read as one contiguous window per row
    block instead of one gathered block per tile."""

    def __init__(self, blocks, cs, blocks_t, cs_t, m, n, bm=128, bn=128):
        self.blocks = blocks        # (nrb, S, bm, bn)
        self.cs = cs                # (nrb,) int32 window start (block cols)
        self.blocks_t = blocks_t    # A' tiles: (ncb, S_t, bn, bm)
        self.cs_t = cs_t
        self.m = m
        self.n = n
        self.bm = bm
        self.bn = bn

    def tree_flatten(self):
        return (self.blocks, self.cs, self.blocks_t, self.cs_t), (
            self.m, self.n, self.bm, self.bn)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def create(cls, A, *, bm=128, bn=128, transpose_table=True):
        """``transpose_table=False`` skips packing the A' tile table:
        ``mv_pair`` (the whole HSDE solve path) computes A'z from the A
        table, so the transpose table only serves standalone ``rmv`` —
        skipping it halves tile memory (and skips one of the two packs)."""
        rows, cols, vals, m, n = _coo_parts(A)
        blocks, cs, _ = _build_band_arrays(
            m, n, rows, cols, vals.astype(np.float32), bm, bn)
        blocks_t = cs_t = None
        if transpose_table:
            blocks_t, cs_t, _ = _build_band_arrays(
                n, m, cols, rows, vals.astype(np.float32), bn, bm)
            blocks_t = jnp.asarray(blocks_t)
            cs_t = jnp.asarray(cs_t)
        return cls(jnp.asarray(blocks), jnp.asarray(cs),
                   blocks_t, cs_t, m, n, bm, bn)

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    def _ncb(self) -> int:
        """Column-block count: the A' table's row count when stored, else
        the same formula the table builder uses — both storage modes must
        compile identical x/y2 block shapes and report identical
        occupancy for the same matrix."""
        if self.blocks_t is not None:
            return self.blocks_t.shape[0]
        return math.ceil(self.n / self.bn)

    def occupancy(self) -> float:
        nrb, S = self.blocks.shape[:2]
        return (nrb * S) / float(nrb * self._ncb())

    def _pad_x(self, x, nblocks, width, S):
        # pad to nblocks*width, then S extra zero blocks so the trailing
        # window [cs, cs + S) never leaves the array
        pad = nblocks * width - x.shape[0] + S * width
        xb = jnp.pad(x, (0, pad)) if pad else x
        return xb.reshape(nblocks + S, width)

    _kernel = staticmethod(_band_mv)
    _pair_kernel = staticmethod(_band_mv_pair)

    def _mv_args(self, x):
        """(index table, tile table, padded input) for the mv kernel —
        shared by the local path and RowShardedOp."""
        S = self.blocks.shape[1]
        return self.cs, self.blocks, self._pad_x(x, self._ncb(), self.bn, S)

    def _rmv_args(self, y):
        if self.blocks_t is None:
            raise TypeError(
                "this BandedBlockOp was built with transpose_table=False "
                "(no A' tile table): use mv_pair for A'z, or rebuild with "
                "BandedBlockOp.create(A, transpose_table=True) for "
                "standalone rmv")
        nrb = self.blocks.shape[0]
        S_t = self.blocks_t.shape[1]
        return self.cs_t, self.blocks_t, self._pad_x(y, nrb, self.bm, S_t)

    def mv(self, x):
        y = _band_mv(*self._mv_args(x))
        return y.reshape(-1)[: self.m]

    def rmv(self, y):
        z = _band_mv(*self._rmv_args(y))
        return z.reshape(-1)[: self.n]

    def mv_pair(self, x, z):
        """(A @ x, A' @ z) from the A tile table alone (the A' table isn't
        touched) — the shape hsde_ops.q_mul consumes."""
        nrb = self.blocks.shape[0]
        pad = nrb * self.bm - z.shape[0]
        zb = (jnp.pad(z, (0, pad)) if pad else z).reshape(nrb, self.bm)
        y1, y2 = _band_mv_pair(*self._mv_args(x), zb)
        return y1.reshape(-1)[: self.m], y2.reshape(-1)[: self.n]

    def todense(self):
        nrb, S, bm, bn = self.blocks.shape
        ncb = self._ncb()
        dense = jnp.zeros((nrb * bm, (ncb + S) * bn), jnp.float32)
        for i in range(nrb):
            for k in range(S):
                ri = jnp.asarray(i * bm, jnp.int32)
                cj = (self.cs[i].astype(jnp.int32) + k) * bn
                dense = jax.lax.dynamic_update_slice(
                    dense,
                    jax.lax.dynamic_slice(dense, (ri, cj), (bm, bn))
                    + self.blocks[i, k],
                    (ri, cj))
        return dense[: self.m, : self.n]

    def astype(self, dtype):
        if jnp.dtype(dtype) == jnp.float32:
            return self
        raise TypeError("BandedBlockOp is f32-only (tile table dtype)")


@jax.tree_util.register_pytree_node_class
class BlockedEllOp:
    """Duck-typed sparse drop-in for A in :mod:`fos_tpu.linalg.hsde_ops`
    (``mv``/``rmv``/``shape``/``todense`` protocol)."""

    def __init__(self, blocks, cols, blocks_t, cols_t, m, n, bm=128, bn=128):
        self.blocks = blocks        # (nrb, kmax, bm, bn)
        self.cols = cols            # (nrb, kmax) int32
        self.blocks_t = blocks_t    # A' tiles: (ncb, kmax_t, bn, bm)
        self.cols_t = cols_t
        self.m = m
        self.n = n
        self.bm = bm
        self.bn = bn

    def tree_flatten(self):
        return (self.blocks, self.cols, self.blocks_t, self.cols_t), (
            self.m, self.n, self.bm, self.bn)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, A, *, bm=128, bn=128, transpose_table=True):
        """Build from a scipy.sparse matrix or a jax BCOO.

        ``transpose_table=False`` skips packing the A' tile table (see
        BandedBlockOp.create): ``mv_pair`` serves A'z from the A table;
        only standalone ``rmv`` needs the transpose table."""
        rows, cols, vals, m, n = _coo_parts(A)
        blocks, cols_tab, _ = _build_ell_arrays(
            m, n, rows, cols, vals.astype(np.float32), bm, bn)
        blocks_t = cols_t_tab = None
        if transpose_table:
            blocks_t, cols_t_tab, _ = _build_ell_arrays(
                n, m, cols, rows, vals.astype(np.float32), bn, bm)
            blocks_t = jnp.asarray(blocks_t)
            cols_t_tab = jnp.asarray(cols_t_tab)
        return cls(jnp.asarray(blocks), jnp.asarray(cols_tab),
                   blocks_t, cols_t_tab, m, n, bm, bn)

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    def _ncb(self) -> int:
        # same formula as the builder: both storage modes must agree
        # (see BandedBlockOp._ncb)
        if self.blocks_t is not None:
            return self.blocks_t.shape[0]
        return math.ceil(self.n / self.bn)

    def occupancy(self) -> float:
        """Stored-tile fraction of the dense tile grid (storage and bytes
        read relative to a dense matvec; padding slots included)."""
        nrb, kmax = self.cols.shape
        return (nrb * kmax) / float(nrb * self._ncb())

    def _pad(self, x, blocks_of, width):
        nb = blocks_of
        pad = nb * width - x.shape[0]
        xb = jnp.pad(x, (0, pad)) if pad else x
        return xb.reshape(nb, width)

    _kernel = staticmethod(_bell_mv)
    _pair_kernel = staticmethod(_bell_mv_pair)

    def _mv_args(self, x):
        """(index table, tile table, padded input) for the mv kernel —
        shared by the local path and RowShardedOp."""
        return self.cols, self.blocks, self._pad(x, self._ncb(), self.bn)

    def _rmv_args(self, y):
        if self.blocks_t is None:
            raise TypeError(
                "this BlockedEllOp was built with transpose_table=False "
                "(no A' tile table): use mv_pair for A'z, or rebuild with "
                "BlockedEllOp.create(A, transpose_table=True) for "
                "standalone rmv")
        nrb = self.blocks.shape[0]
        return self.cols_t, self.blocks_t, self._pad(y, nrb, self.bm)

    def mv(self, x):
        y = _bell_mv(*self._mv_args(x))
        return y.reshape(-1)[: self.m]

    def rmv(self, y):
        z = _bell_mv(*self._rmv_args(y))
        return z.reshape(-1)[: self.n]

    def mv_pair(self, x, z):
        """(A @ x, A' @ z) from the A tile table alone (see
        BandedBlockOp.mv_pair)."""
        nrb = self.blocks.shape[0]
        zb = self._pad(z, nrb, self.bm)
        y1, y2 = _bell_mv_pair(*self._mv_args(x), zb)
        return y1.reshape(-1)[: self.m], y2.reshape(-1)[: self.n]

    def todense(self):
        nrb, kmax, bm, bn = self.blocks.shape
        ncb = self._ncb()
        dense = jnp.zeros((nrb * bm, ncb * bn), jnp.float32)
        # scatter tiles (build-time utility; not a hot path)
        for i in range(nrb):
            for k in range(kmax):
                ri = jnp.asarray(i * bm, jnp.int32)
                cj = self.cols[i, k].astype(jnp.int32) * bn
                dense = jax.lax.dynamic_update_slice(
                    dense,
                    jax.lax.dynamic_slice(dense, (ri, cj), (bm, bn))
                    + self.blocks[i, k],
                    (ri, cj))
        return dense[: self.m, : self.n]

    def astype(self, dtype):
        if jnp.dtype(dtype) == jnp.float32:
            return self
        raise TypeError("BlockedEllOp is f32-only (tile table dtype)")


def bell_storage_ratio(A, bm=128, bn=128) -> float:
    """Blocked-ELL storage (both A and A' layouts) relative to one dense
    copy — the build layer's profitability estimate.  Computed from the
    index pattern only (no tile data materialized)."""
    rows, cols, _, m, n = _coo_parts(A)
    nrb = math.ceil(m / bm)
    ncb = math.ceil(n / bn)
    ti = rows // bm
    tj = cols // bn
    pair = ti.astype(np.int64) * ncb + tj
    upair = np.unique(pair)
    kmax = int(np.bincount(upair // ncb, minlength=nrb).max()) if upair.size else 1
    kmax_t = int(np.bincount(upair % ncb, minlength=ncb).max()) if upair.size else 1
    return ((nrb * kmax + ncb * kmax_t) * bm * bn) / float(m * n)


@jax.tree_util.register_pytree_node_class
class RowShardedOp:
    """Multi-device wrapper for a :class:`BandedBlockOp` / :class:`BlockedEllOp`:
    tile arrays (the big data) are sharded by block-row over a mesh axis,
    ``mv``/``rmv`` run the LOCAL tile product per device under
    ``shard_map`` and all-gather the (small, O(m)+O(n)) result vectors.
    x/y stay replicated — the communication pattern of SURVEY.md §5 with
    the matvec itself kept out of GSPMD's hands (``shard_map`` makes the
    split explicit, and a Pallas kernel is opaque to the partitioner).

    Both the A and A' tile tables are sharded along their OWN row axes, so
    neither direction needs a reduction — one tiled all-gather each.

    ``axis`` may be a single mesh-axis name or a TUPLE of names for
    hierarchical meshes (e.g. ``("host", "local")``): block rows are split
    over the axis product (outer axis major, matching ``PartitionSpec``
    order) and the result all-gather runs over the same product group —
    XLA decomposes it into the per-axis phases, so the big tile tables
    never move and only the O(m)+O(n) vectors cross hosts.
    """

    def __init__(self, inner, mesh, axis="model"):
        self.inner = inner
        self.mesh = mesh
        self.axis = (axis,) if isinstance(axis, str) else tuple(axis)

    def tree_flatten(self):
        return (self.inner,), (self.mesh, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @classmethod
    def create(cls, op, mesh, axis="model"):
        """Shard ``op``'s tile leaves P(axis, ...).  Block-row counts are
        zero-padded to a multiple of the axis-product size first (zero
        tiles with index 0 contribute nothing), so any matrix works on any
        mesh."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        ndev = 1
        for a in axes:
            ndev *= mesh.shape[a]

        def pad0(x):
            r = (-x.shape[0]) % ndev
            if r:
                x = jnp.concatenate(
                    [x, jnp.zeros((r,) + x.shape[1:], x.dtype)], axis=0)
            return x

        ch, aux = op.tree_flatten()   # (blocks, idx, blocks_t, idx_t)
        placed = tuple(
            jax.device_put(pad0(x),
                           NamedSharding(mesh, P(axes,
                                                 *([None] * (x.ndim - 1)))))
            if x is not None else None   # transpose_table=False ops
            for x in ch)
        return cls(type(op).tree_unflatten(aux, placed), mesh, axes)

    # -- protocol ----------------------------------------------------
    @property
    def shape(self):
        return self.inner.shape

    @property
    def m(self):
        return self.inner.m

    @property
    def n(self):
        return self.inner.n

    @property
    def dtype(self):
        return self.inner.dtype

    def _sharded_kernel(self, idx, blocks, xb):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        kernel = type(self.inner)._kernel
        axes = self.axis

        def local(idx_l, blocks_l, xb_l):
            y = kernel(idx_l, blocks_l, xb_l)
            # multi-axis: MUST gather the INNER (minor) axis first — shard
            # order over P(("host","local")) is outer-major (device (h,l)
            # holds shard h*n_local + l), and only inner-first gathering
            # reassembles that order (outer-first would interleave:
            # [s0,s4,s1,s5,...] on a 2x4 mesh).  A bonus, not the reason:
            # the later cross-host phase then moves one contiguous block.
            for a in reversed(axes):
                y = jax.lax.all_gather(y, a, axis=0, tiled=True)
            return y

        nd1 = blocks.ndim - 1
        return shard_map(
            local, mesh=self.mesh,
            in_specs=(P(axes, *([None] * (idx.ndim - 1))),
                      P(axes, *([None] * nd1)), P(None, None)),
            out_specs=P(None, None), check_vma=False,
        )(idx, blocks, xb)

    def mv(self, x):
        idx, blocks, xb = self.inner._mv_args(x)
        y = self._sharded_kernel(idx, blocks, xb)
        return y.reshape(-1)[: self.inner.m]

    def rmv(self, y):
        idx, blocks, yb = self.inner._rmv_args(y)
        z = self._sharded_kernel(idx, blocks, yb)
        return z.reshape(-1)[: self.inner.n]

    def mv_pair(self, x, z):
        """(A @ x, A' @ z) from the sharded A table alone: each device
        runs the local pair on its block rows, then y1 = tiled all-gather
        over the row axis (as mv) and y2 = psum of the per-device partial
        A'z (a device's rows contribute only to its own column windows,
        zero elsewhere)."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        inner = self.inner
        idx, blocks, xb = inner._mv_args(x)
        nrb = blocks.shape[0]
        bm = blocks.shape[-2]
        pad = nrb * bm - z.shape[0]
        zb = (jnp.pad(z, (0, pad)) if pad else z).reshape(nrb, bm)
        kernel = type(inner)._pair_kernel
        axes = self.axis

        def local(idx_l, blocks_l, xb_l, zb_l):
            y1, y2 = kernel(idx_l, blocks_l, xb_l, zb_l)
            for a in reversed(axes):  # inner-first (see _sharded_kernel)
                y1 = jax.lax.all_gather(y1, a, axis=0, tiled=True)
            y2 = jax.lax.psum(y2, axes)
            return y1, y2

        nd1 = blocks.ndim - 1
        y1, y2 = shard_map(
            local, mesh=self.mesh,
            in_specs=(P(axes, *([None] * (idx.ndim - 1))),
                      P(axes, *([None] * nd1)), P(None, None), P(axes, None)),
            out_specs=(P(None, None), P(None, None)), check_vma=False,
        )(idx, blocks, xb, zb)
        return (y1.reshape(-1)[: inner.m], y2.reshape(-1)[: inner.n])

    def todense(self):
        return self.inner.todense()

    def astype(self, dtype):
        if jnp.dtype(dtype) == jnp.float32:
            return self
        raise TypeError("RowShardedOp is f32-only (tile table dtype)")


def _coo_parts(A):
    """Extract (rows, cols, vals, m, n) from scipy.sparse or BCOO."""
    if hasattr(A, "tocoo"):  # scipy.sparse
        coo = A.tocoo()
        return (np.asarray(coo.row), np.asarray(coo.col),
                np.asarray(coo.data), *A.shape)
    if hasattr(A, "indices"):  # jax BCOO
        idx = np.asarray(A.indices)
        return (idx[:, 0], idx[:, 1], np.asarray(A.data), *A.shape)
    raise TypeError(f"cannot build BlockedEllOp from {type(A)}")
