"""Process setup shared by the entry points: the compile-cache directory and
the --platform check."""

import jax
import pytest

from romap_tpu.utils import jax_env


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_defaults_to_the_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    got = jax_env.setup_compile_cache()
    assert got == jax_env.REPO_CACHE_DIR
    assert got.endswith("/.jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_cache_dir_from_the_environment_sets_nothing(
        monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert jax_env.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_select_platform_gpu_fails_without_a_gpu():
    assert jax.default_backend() == "cpu"
    jax_env.select_platform(None)
    jax_env.select_platform("cpu")
    with pytest.raises(RuntimeError, match="gpu"):
        jax_env.select_platform("gpu")
