"""Global configuration for fos_tpu.

First-order conic solvers need f64 to reach the reference operating points
(eps down to 1e-9, see the reference's test/testDRandGAPA.jl:45); the
per-solve ``dtype`` option offers an f32 path for loose tolerances.  x64 is
enabled at import unless ``FOS_TPU_X64=0``.
"""

import os

import jax
import jax.numpy as jnp

if os.environ.get("FOS_TPU_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)

#: persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
#: a fixed path inside the checkout (the path is part of the cache key)
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache for a script run.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    does nothing (returns None).  Otherwise the cache goes to
    :data:`COMPILE_CACHE_DIR` and that path is returned."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


def densify_fits(dense_bytes: int, bytes_limit) -> bool:
    """Auto-densify gate: a dense copy of A may take a quarter of the
    device memory the allocator may use (``memory_stats()["bytes_limit"]``);
    no limit known (the CPU backend) -> never auto-densify."""
    return bool(bytes_limit) and dense_bytes < int(bytes_limit) // 4


def device_bytes_limit():
    """``bytes_limit`` of the default device, or None where the backend
    reports no memory statistics (CPU)."""
    stats = jax.devices()[0].memory_stats()
    return (stats or {}).get("bytes_limit")


def default_dtype():
    """Solver default dtype: f64 when x64 is enabled, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def eps_of(dtype) -> float:
    return float(jnp.finfo(dtype).eps)
