"""What the program needs around the solver to run on the card: the
compile-cache location, the benchmark's peak table, chip_smoke.py's refusal
without a GPU, and the pair-mesh sweep against the known poses."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from psulvsb_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.compile_cache_dir() == str(tmp_path)

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.compile_cache_dir()
        assert path == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

    def test_enable_sets_jax_config(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        try:
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestPeakTable:
    def test_h100_peaks(self):
        import bench

        peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
        assert peaks["bf16_flops"] == 989e12
        assert peaks["hbm_bytes_per_s"] == 3.35e12

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
    def test_unknown_device_kind_raises(self, kind):
        import bench

        with pytest.raises(KeyError):
            bench.device_peaks(kind)


class TestChipSmokeRefuses:
    def _run(self, cwd):
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        env.pop("PYTHONPATH", None)
        return subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )

    def test_exits_nonzero_without_gpu(self):
        r = self._run(REPO)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_exits_nonzero_without_the_program(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = self._run(tmp_path)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_sharded_sweep_matches_single_device_and_poses():
    """register_batch_sharded over a 4-device mesh (virtual CPU devices)
    against register_batch for the same keys and the known poses — the
    check chip_smoke.py --four-cards runs on four cards."""
    from psulvsb_tpu.eval.kernel_checks import check_sharded_sweep

    assert len(jax.devices()) >= 4
    out = check_sharded_sweep(n_pairs=8, c=300, n_devices=4)
    assert out["devices"] == 4
