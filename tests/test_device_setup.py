"""Device peak table, compile-cache location and the GPU smoke script's
refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from openpose_tpu.utils import benchmark, compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


class TestPeaks:
    def test_h100_published_peaks(self):
        kind = "NVIDIA H100 80GB HBM3"
        assert benchmark.device_peak("bf16", kind) == 989.0
        assert benchmark.device_peak("tf32", kind) == 495.0
        assert benchmark.device_peak("fp32", kind) == 67.0
        assert benchmark.device_peak("hbm_tbps", kind) == 3.35

    def test_unknown_device_raises(self):
        with pytest.raises(KeyError, match="no published peaks"):
            benchmark.device_peak("bf16", "Some Other Accelerator")
        with pytest.raises(KeyError):      # the CPU test mesh has no peak
            benchmark.device_peak("bf16")


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore_config(self):
        old = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", old)

    def test_env_dir_used_as_given(self, monkeypatch, tmp_path):
        target = tmp_path / "cache"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
        assert compile_cache.enable_persistent_cache() == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir() and not any(target.iterdir())

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        first = compile_cache.enable_persistent_cache()
        assert first == str(REPO / ".jax_cache")
        assert compile_cache.enable_persistent_cache() == first
        assert jax.config.jax_compilation_cache_dir == first


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits non-zero and prints no verdict."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout
