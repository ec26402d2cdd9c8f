"""Device-mesh sharding for large problems and instance batches.

The reference has no distribution story at all (SURVEY.md §2c); the
scale-out follows the GSPMD recipe: build a
``jax.sharding.Mesh``, annotate the data layout with ``NamedSharding``, jit
the *same* solver code, and let XLA insert the collectives.  The only
communication points are the ones identified in SURVEY.md §5: the two dot
products per CG iteration, the matvec reductions when A is sharded, and the
residual norms in the convergence check — all become ``psum``-style
collectives that XLA inserts (NCCL on the GPU).

Two axes:

* ``batch`` — independent problem instances (data parallel);
* ``model`` — row-block sharding of A for one large problem (tensor
  parallel): ``A: P('model', None)``, ``b: P('model')``, c replicated; the
  HSDE iterate z is kept replicated (it is ~m+n, small next to A).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Sequence[int] = None, names: Sequence[str] = ("batch", "model"),
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices), 1)
    mesh_devices = np.asarray(devices).reshape(shape)
    return Mesh(mesh_devices, names)


def make_hybrid_mesh(outer: int, inner: int,
                     names: Sequence[str] = ("batch", "model")) -> Mesh:
    """Hierarchical mesh for multi-host runs: the ``outer`` axis is the
    cross-host axis (one group per host — put the data-parallel batch axis
    there, it only communicates at termination voting), the ``inner`` axis
    the in-host axis (model/row sharding — it carries the psum per CG dot
    over the host's fast card-to-card links).  On a real multi-host runtime
    the assignment uses ``mesh_utils.create_hybrid_device_mesh`` so
    inner-axis neighbours share a host; on one host (or the virtual CPU
    mesh) it reduces to a reshape, which keeps the layout semantics
    testable anywhere.
    """
    devices = jax.devices()
    if outer * inner != len(devices):
        raise ValueError(f"mesh {outer}x{inner} != {len(devices)} devices")
    if jax.process_count() > 1:
        from jax.experimental import mesh_utils

        mesh_devices = mesh_utils.create_hybrid_device_mesh(
            (inner,), (outer,), devices=devices)
        # hybrid util returns (cross-host, in-host)-ordered axes already
        return Mesh(mesh_devices.reshape(outer, inner), names)
    return Mesh(np.asarray(devices).reshape(outer, inner), names)


def shard_batched_form(form, mesh: Mesh, axis: str = "batch"):
    """Place a batched HSDEForm so the instance axis is split over ``axis``."""
    def put(x):
        if x is None or not hasattr(x, "ndim"):
            return x
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, form)


def _rebuild_row_sharded(form, put_A, put_b, put_c, put_rest):
    """Reassemble an HSDEForm with per-FIELD placements.

    Dispatch keys on the form's named structure (the pytree layouts we own:
    HSDEForm children are (sets, A, b, c, norm_b, norm_c, dinv, einv) and
    the S1 projector's are (A, b, c, fac)), NOT on leaf shapes — so square
    problems (m == n) shard correctly too (r2 weak item 3)."""
    s1 = form.sets.s1
    if s1.A is not None and (hasattr(s1.A, "todense")
                             or not hasattr(s1.A, "ndim")):
        # BCOO also has .ndim, so a dense-duck check alone lets it through
        # to an opaque device_put shape error on its (nnz,)-shaped leaves
        raise ValueError(
            f"row sharding supports dense A only (got {type(s1.A).__name__});"
            " for sparse data either shard the raw matrix with "
            "shard_problem_2d before building the form, or wrap a "
            "BlockedEllOp/BandedBlockOp in parallel.RowShardedOp (tile "
            "tables sharded, local tile products under shard_map)")
    ch, aux = s1.tree_flatten()          # (A, b, c, fac, ...)
    A, b, c, fac = ch[0], ch[1], ch[2], ch[3]
    s1n = type(s1).tree_unflatten(
        aux, (put_A(A), put_b(b), put_c(c), put_rest(fac)) + tuple(
            put_rest(x) for x in ch[4:]))
    s2n = jax.tree_util.tree_map(put_rest, form.sets.s2)
    sets = type(form.sets)(s1n, s2n)
    fch, faux = form.tree_flatten()      # (sets, A, b, c, nb, nc, dinv, einv)
    _, A0, b0, c0, nb, nc, dinv, einv = fch
    new_children = (sets, put_A(A0), put_b(b0), put_c(c0), put_rest(nb),
                    put_rest(nc), put_b(dinv), put_c(einv))
    return type(form).tree_unflatten(faux, new_children)


def shard_problem_rows(form, mesh: Mesh, axis: str = "model"):
    """Row-block shard one large problem: A by rows, b (and the row weights
    dinv) alongside; c and the iterate stay replicated.  A'y then contracts
    over the sharded row axis (XLA inserts the psum); A x is local per row
    block.  Placement keys on the form's named fields, so square problems
    (m == n) work."""
    s_rows2d = NamedSharding(mesh, P(axis, None))
    s_rows1d = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def put(sharding):
        def f(x):
            if x is None or not hasattr(x, "ndim"):
                return x
            return jax.device_put(x, sharding)
        return f

    def put_repl(x):
        if x is None or not hasattr(x, "ndim"):
            return x
        return jax.device_put(x, repl)

    return _rebuild_row_sharded(form, put(s_rows2d), put(s_rows1d),
                                put_repl, put_repl)


def shard_batched_form_rows(form, mesh: Mesh, batch_axis: str = "batch",
                            model_axis: str = "model"):
    """Combined data x model parallelism for a batched HSDEForm: instances
    split over ``batch_axis`` (no per-iteration traffic, so it may cross
    hosts) AND each instance's A row-sharded over ``model_axis`` (a psum
    per CG dot, so keep it inside a host).  This is the two-level layout
    for several hosts — e.g. a (hosts, 4) mesh from
    :func:`make_hybrid_mesh`.

    Layouts (keyed on the form's named fields, batched leaves carry a
    leading instance axis): A (B,m,n): P(batch, model, None); b / dinv
    (B,m): P(batch, model); c / einv (B,n) and the rest: P(batch, ...).
    """
    s_A = NamedSharding(mesh, P(batch_axis, model_axis, None))
    s_b = NamedSharding(mesh, P(batch_axis, model_axis))

    def put_spec(sharding):
        def f(x):
            if x is None or not hasattr(x, "ndim"):
                return x
            return jax.device_put(x, sharding)
        return f

    def put_batch(x):
        if x is None or not hasattr(x, "ndim") or x.ndim == 0:
            return x
        spec = P(batch_axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return _rebuild_row_sharded(form, put_spec(s_A), put_spec(s_b),
                                put_batch, put_batch)


def shard_problem_2d(A, b, c, mesh: Mesh, axes=("model_r", "model_c")):
    """2D block-shard one large problem's data BEFORE building the form:
    ``A: P(r, c)``, ``b: P(r)``, ``c: P(c)``; everything derived inside
    ``HSDEForm.build`` (norms, projector state) and the solver iterate then
    inherit layouts from GSPMD propagation — the CG matvec becomes local
    GEMM blocks + an all-reduce over the contracted axis, exactly
    the communication points of SURVEY.md §5.

    Returns device_put (A, b, c); pass them to ``conic_problem`` /
    ``HSDEForm.build`` as usual.  Sharding the raw data (rather than the
    built form pytree) keeps b/c unambiguous when m == n.
    """
    r, cx = axes
    A = jax.device_put(A, NamedSharding(mesh, P(r, cx)))
    b = jax.device_put(b, NamedSharding(mesh, P(r)))
    c = jax.device_put(c, NamedSharding(mesh, P(cx)))
    return A, b, c
