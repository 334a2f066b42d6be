"""Persistent compile cache location (utils/compile_cache.py)."""

import os

import jax

from matfac_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert calls == []


def test_default_is_one_fixed_dir_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    first = compile_cache.enable_compile_cache()
    second = compile_cache.enable_compile_cache()
    assert first == second == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
