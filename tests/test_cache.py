"""Where the persistent compilation cache goes."""

import os

import jax

from ldpcgputegra.utils import cache


def test_env_var_is_honoured_and_nothing_else_set(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_the_fixed_in_repo_path(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert cache.DEFAULT_CACHE_DIR == want
    assert cache.enable_compile_cache() == want
    assert ("jax_compilation_cache_dir", want) in calls
    assert os.path.isdir(want)
