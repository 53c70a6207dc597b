"""Where the persistent compile cache and the prewarm shape journal live:
JAX_COMPILATION_CACHE_DIR when it is set, else one fixed directory inside
the checkout."""

import os

from longcalld_tpu.utils import device, prewarm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_cache_dir_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.cache_dir() == str(tmp_path)
    assert prewarm._journal_path() == str(tmp_path / "shape_journal.jsonl")


def test_default_cache_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.cache_dir() == os.path.join(ROOT, ".jax_cache")
    assert prewarm._journal_path() == os.path.join(
        ROOT, ".jax_cache", "shape_journal.jsonl")

