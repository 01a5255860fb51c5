"""delphy_tpu — a JAX Bayesian phylogenetics engine.

A from-scratch re-design of the Explicit Mutation-Annotated Tree (EMAT) method of
broadinstitute/delphy for JAX/XLA on an accelerator.  The MCMC state lives in
fixed-capacity flat device arrays (node arrays + mutation pool + missation CSR
tables); all likelihood math is expressed as vectorized segment sums, prefix
scans and pointer-jumping gathers instead of the reference's pointer/arena C++
structures.

Double precision is required for the log-posterior ledger discipline
(reference tolerances 1e-6..1e-8, see core/run.cpp:316-338), so x64 mode is
enabled package-wide.
"""

import os

import jax

# Precision: double by default (the reference's ledger tolerances are
# 1e-6..1e-8, run.cpp:316-338).  DELPHY_TPU_F32=1 runs the whole engine in
# single precision: the full ledger recompute at every global boundary resets
# f32 accumulation drift, and MH log-ratios at 1e-7 relative error are
# statistically negligible.  Times at f32 resolve ~5 seconds over a
# +-1000-day axis.
if not os.environ.get("DELPHY_TPU_F32"):
    jax.config.update("jax_enable_x64", True)
else:
    import warnings
    warnings.filterwarnings(
        "ignore", message="Explicitly requested dtype.*(float|int)64")
if os.environ.get("DELPHY_TPU_FORCE_CPU"):
    jax.config.update("jax_platforms", "cpu")


def compile_cache_dir(environ=os.environ):
    """Where this package puts JAX's persistent compilation cache: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself), else a fixed
    `.jax_cache` in the checkout (a fixed path, because the path is part of
    the cache key)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .version import __version__  # noqa: E402,F401
