"""Shared CLI plumbing: gflags-style argument handling and backend setup."""

from __future__ import annotations

import argparse
import os

# <checkout>/.jax_compile_cache: a fixed path (it is part of the cache key),
# listed in .gitignore.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_compile_cache",
)


def make_parser(description: str) -> argparse.ArgumentParser:
    # gflags accepts both --flag=value and --flag value; argparse does too.
    return argparse.ArgumentParser(description=description, allow_abbrev=False)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and no
    other setting is touched. Otherwise the cache goes to the fixed
    ``<checkout>/.jax_compile_cache``. Returns the directory in use.
    """
    import jax

    from_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if from_env:
        # JAX reads the variable when it is imported; this also covers a
        # variable set after that.
        jax.config.update("jax_compilation_cache_dir", from_env)
        return from_env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_COMPILE_CACHE_DIR


def setup_backend(dtype_flag: str = "auto"):
    """Set up the compile cache, choose the compute dtype by backend and
    enable x64 when needed.

    float64 on CPU matches the reference numerics exactly; float32 on the
    GPU (the device default precision for the calibration and VO programs).
    Returns the jnp dtype to use.
    """
    import jax
    import jax.numpy as jnp

    setup_compile_cache()
    if dtype_flag == "auto":
        dtype_flag = "float64" if jax.default_backend() == "cpu" else "float32"
    if dtype_flag == "float64":
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def add_dtype_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--dtype",
        choices=["auto", "float32", "float64"],
        default="auto",
        help="Compute precision; auto = float64 on CPU, float32 on a GPU.",
    )
