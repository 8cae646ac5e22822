"""Process-level JAX setup shared by every entry point.

`setup_compile_cache()` gives every entry point one persistent compilation
cache: the directory `JAX_COMPILATION_CACHE_DIR` names when it is set, and
otherwise the fixed path `<repo>/.jax_cache` (the path is part of the cache
key, so it must not move between runs). `select_platform()` pins or checks
the backend for the `--platform` flags.

One JAX process opens a card at a time: a process reserves most of the
card's memory when it first uses it, so a second one fails for want of it.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Sets nothing when JAX_COMPILATION_CACHE_DIR is set (JAX
    reads the variable itself)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def select_platform(platform: str | None) -> None:
    """`cpu` pins JAX to the host; `gpu` requires a GPU backend and raises
    if JAX finds none. None leaves JAX's own choice. Call before any other
    JAX use."""
    if platform is None:
        return
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    backend = jax.default_backend()
    if backend != platform:
        raise RuntimeError(
            f"--platform {platform} requested but JAX's backend is {backend!r}")
