"""The persistent compilation cache location set by entry points."""

import os

import jax
import pytest

from mayamatchmovesolver_tpu import cli
from mayamatchmovesolver_tpu.utils import compile_cache

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_set_means_nothing_set_in_code(monkeypatch, tmp_path,
                                               restore_cache_dir):
    monkeypatch.setenv(compile_cache.CACHE_DIR_ENV, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


def test_env_var_unset_uses_fixed_checkout_dir(monkeypatch,
                                               restore_cache_dir):
    monkeypatch.delenv(compile_cache.CACHE_DIR_ENV, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # Fixed: a second call (another process, another day) gives the
    # same directory.
    assert compile_cache.enable_compile_cache() == path


def test_cli_main_enables_the_cache(monkeypatch, capsys,
                                    restore_cache_dir):
    monkeypatch.delenv(compile_cache.CACHE_DIR_ENV, raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    assert cli.main(["formats"]) == 0
    assert jax.config.jax_compilation_cache_dir == \
        compile_cache.CHECKOUT_CACHE_DIR
