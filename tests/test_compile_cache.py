"""The one compile-cache helper every entry point calls."""

import os

import jax
import pytest

from latticeqcd_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False], ids=["env set", "env unset"])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.configure_compile_cache()
    if env_set:
        # JAX reads the variable itself; nothing else is set
        assert path == str(tmp_path) and calls == []
    else:
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
