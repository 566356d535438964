"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it is
set, and otherwise one fixed directory inside the checkout."""

from pathlib import Path

import jax

from lz4_sgori_tpu.utils.compile_cache import enable_compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_env_var_is_used_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_one_fixed_directory_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
