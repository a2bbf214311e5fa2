"""Process environment shared by every entry point: the compile cache and
the identity of the card a measurement ran on."""

from __future__ import annotations

import os
import subprocess

__all__ = ["REPO_CACHE_DIR", "compile_cache_dir", "setup_compile_cache", "gpu_info"]

# <repo>/.jax_cache: a fixed path, so a later run in the same checkout hits
# what an earlier one compiled (the path is part of the cache's key).
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str | None:
    """The directory this process should set as JAX's compile cache, or
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that itself,
    and nothing is set in code)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card). Raises if nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
