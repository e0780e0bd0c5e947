"""Compilation-cache directory selection (partitionedarrays_tpu.config)."""
import os
import types

import jax
import pytest

from partitionedarrays_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_dir_selection(env_set, monkeypatch, tmp_path):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
        assert config.compilation_cache_dir() == str(tmp_path / "cc")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert config.compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
        assert config.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compilation_cache_on_gpu(env_set, monkeypatch, tmp_path):
    """On a GPU platform the cache is switched on at exactly the selected
    directory (and nowhere else)."""
    updates = {}
    monkeypatch.setattr(
        jax, "devices", lambda *a: [types.SimpleNamespace(platform="gpu")]
    )
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
        want = str(tmp_path / "cc")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    assert config.enable_compilation_cache() == want
    assert updates["jax_compilation_cache_dir"] == want
    assert [k for k in updates if "cache_dir" in k] == ["jax_compilation_cache_dir"]
    assert os.path.isdir(want)


def test_enable_compilation_cache_skips_cpu(monkeypatch):
    updates = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    assert config.enable_compilation_cache() is None
    assert updates == {}
